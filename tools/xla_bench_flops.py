"""XLA's FLOP count of ``bench.py``'s train steps, for comparison with the
PyTorch port's count (``diffusion_extensions_tpu_torch/flops.py``, held to
``torch.utils.flop_counter.FlopCounterMode``).

Builds each step as ``bench.py`` does, at its full width, with the weights
and optimizer state as abstract shapes (``jax.eval_shape``: nothing is
allocated), lowers and compiles it on the CPU and reads
``bench._flops_per_step``: nothing runs.  XLA counts every operation of
the step (the forward and backward products, the elementwise work and
Adam); a fused K-step call counts its ``lax.scan`` body once, so each
number is one step's.

    python tools/xla_bench_flops.py [row ...]

Rows: aircraft (the headline), moe_train_e4, protein_train_b4,
protein_train_b16, protein_train_b32, protein_train_b4_opt (default: all).
Prints one JSON line {row: GFLOP a step}.
"""
from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("DXT_JAX_CACHE", os.path.join(REPO, ".jax_cache"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

import bench  # noqa: E402
from diffusion_extensions_tpu.parallel.dp import make_dp_train_step  # noqa: E402
from diffusion_extensions_tpu.parallel.mesh import make_mesh  # noqa: E402
from diffusion_extensions_tpu.train.optim import make_optimizer  # noqa: E402
from diffusion_extensions_tpu.train.state import TrainState  # noqa: E402

ROWS = ("aircraft", "moe_train_e4", "protein_train_b4", "protein_train_b16",
        "protein_train_b32", "protein_train_b4_opt")


def _abstract_state(init, tx):
    key = jax.random.PRNGKey(0)
    return jax.eval_shape(lambda k: TrainState.create(init(k), tx, k), key)


def aircraft_step_flops(moe_experts: int = 0) -> float:
    """bench.py ``bench_aircraft`` with its defaults (bf16, batch 32 x 256
    points, K = 8, optax Adam)."""
    from diffusion_extensions_tpu.experiments.aircraft import make_loss_fn
    from diffusion_extensions_tpu.models.planenet import PlaneNet
    from diffusion_extensions_tpu.processes.so3 import ProjectedSO3Diffusion

    K, batch, points = 8, 32, 256
    model = PlaneNet(dim=512, heads=4, layers=4, bf16=True, moe_experts=moe_experts,
                     moe_dispatch="scatter")
    process = ProjectedSO3Diffusion(timesteps=1000)
    truepos = jnp.broadcast_to(jnp.eye(3), (batch, 3, 3))
    tx = optax.adam(1e-4)
    state = _abstract_state(lambda k: {"params": model.init(
        k, jnp.zeros((batch, points, 3)), jnp.zeros((batch,), jnp.int32))["params"]}, tx)
    step_fn = make_dp_train_step(make_loss_fn(model, process, truepos, so3=True), tx,
                                 make_mesh(), steps_per_call=K)
    clouds = jax.ShapeDtypeStruct((K, batch, points, 3), jnp.float32)
    return bench._flops_per_step(step_fn, state, clouds)


def protein_step_flops(batch: int, opt: bool = False) -> float:
    """bench.py ``bench_protein``: ProtNet d1024 / h8 / t12 / c8, bf16,
    optax Adam at K = 1, or fused Adam with bf16 moments at K = 8."""
    from diffusion_extensions_tpu.data.pdb import pad_prot_batch, synthetic_prot_pair
    from diffusion_extensions_tpu.models.projections import ProtProjection
    from diffusion_extensions_tpu.models.protnet import ProtNet
    from diffusion_extensions_tpu.ops.se3 import AffineT
    from diffusion_extensions_tpu.processes.se3 import ProjectedSE3Diffusion

    rng = np.random.default_rng(0)
    pairs = [synthetic_prot_pair(rng) for _ in range(16)]
    lr = max(p[0].positions.shape[0] for p in pairs)
    ll = max(p[1].positions.shape[0] for p in pairs)
    pb = jax.tree_util.tree_map(
        jnp.asarray, pad_prot_batch([pairs[i % len(pairs)] for i in range(batch)], lr, ll))
    model = ProtNet(dim=1024, heads=8, t_depth=12, c_depth=8, se3=True, bf16=True)
    process = ProjectedSE3Diffusion(timesteps=1000)
    tx = (make_optimizer(1e-4, impl="fused", state_dtype="bf16") if opt
          else optax.adam(1e-4))
    state = _abstract_state(lambda k: model.init(k, pb, jnp.zeros((batch,), jnp.int32)), tx)
    truepos = AffineT(jnp.broadcast_to(jnp.eye(3), (batch, 3, 3)), jnp.zeros((batch, 3)))
    K = 8 if opt else 1

    def loss_fn(params, key, pb):
        return process.loss(lambda x, t: model.apply(params, x, t), key, truepos,
                            projection=ProtProjection(pb, se3=True))

    step_fn = make_dp_train_step(loss_fn, tx, make_mesh(devices=jax.devices()[:1]),
                                 steps_per_call=K, log_norms=False, donate=False)
    if K > 1:
        pb = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x[None], (K,) + x.shape), pb)
    return bench._flops_per_step(step_fn, state, pb)


def row_flops(row: str) -> float:
    if row == "aircraft":
        return aircraft_step_flops()
    if row == "moe_train_e4":
        return aircraft_step_flops(moe_experts=4)
    if row == "protein_train_b4_opt":
        return protein_step_flops(4, opt=True)
    return protein_step_flops(int(row.rsplit("_b", 1)[1]))


def main(argv=None) -> dict:
    rows = list(argv if argv is not None else sys.argv[1:]) or list(ROWS)
    unknown = [r for r in rows if r not in ROWS]
    if unknown:
        raise SystemExit(f"unknown rows {unknown}; rows: {', '.join(ROWS)}")
    out = {row: row_flops(row) / 1e9 for row in rows}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
