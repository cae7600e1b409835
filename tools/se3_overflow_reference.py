"""Does the JAX package's SE(3) DDIM chain overflow where the port's does?

At the seeded init's own output scale, the port's SE(3) DDIM chain at the
headline width (ProtNet dim 1024 / 8 heads / t_depth 12 / c_depth 8 with
frame_pool, cross_depth 2, rel_frame, equiv_head) overflows float32: the
untrained head's predicted shift moves the ligand, whose pooled position
feeds the head back.  This tool runs both packages' DDIM steps from one
start on the CPU: the port's seeded init (``torch.manual_seed(seed)``, no
head scaling) converted into a flax tree, the port's x_init (Haar-QR
rotations and unit normal shifts from a seeded generator), the driver's
synthetic pairs, and each package's own ``_ddim_map`` (the JAX chain's scan
body) on the same evenly spaced grid.  It prints each step's largest
|shift| on both sides and the first step at which each goes non-finite.

    python tools/se3_overflow_reference.py [--batch 2] [--steps 50]

It imports JAX and the JAX package (it is a tool, not part of the port) and
needs about 3 GB of memory at the default width and batch.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from diffusion_extensions_tpu.data.pdb import pad_prot_batch as j_pad  # noqa: E402
from diffusion_extensions_tpu.data.pdb import synthetic_prot_pair as j_pair  # noqa: E402
from diffusion_extensions_tpu.models.projections import ProtProjection as JProj  # noqa: E402
from diffusion_extensions_tpu.models.protnet import ProtNet as JProtNet  # noqa: E402
from diffusion_extensions_tpu.ops import se3 as jse3  # noqa: E402
from diffusion_extensions_tpu.processes.se3 import ProjectedSE3Diffusion as JProc  # noqa: E402
from diffusion_extensions_tpu_torch import convert  # noqa: E402
from diffusion_extensions_tpu_torch.data.pdb import to_device  # noqa: E402
from diffusion_extensions_tpu_torch.models.projections import ProtProjection  # noqa: E402
from diffusion_extensions_tpu_torch.models.protnet import ProtNet  # noqa: E402
from diffusion_extensions_tpu_torch.ops.se3 import AffineT  # noqa: E402
from diffusion_extensions_tpu_torch.ops.so3 import haar_rotations  # noqa: E402
from diffusion_extensions_tpu_torch.processes.se3 import ProjectedSE3Diffusion  # noqa: E402
from diffusion_extensions_tpu_torch.processes.so3 import _linspace_grid  # noqa: E402

FLAGS = dict(frame_pool=True, cross_depth=2, rel_frame=True, equiv_head=True)


def flax_tree_from_port(state: dict, shapes: dict, mapping: dict) -> dict:
    """The inverse of ``convert.protnet_params_from_flax``: each flax leaf
    is its port tensor transposed and reshaped to the flax shape, checked
    by mapping it forward again."""
    tree = {}
    for path, (key, fn) in mapping.items():
        w = state[key].detach().cpu().numpy()
        shape = shapes[path]
        if w.ndim == 3:  # conv (Cout, Cin, 3) -> (3, Cin, Cout)
            leaf = w.transpose(2, 1, 0)
        elif w.ndim == 2:  # Linear (out, in) -> (in, out), reshaped for q/k/v/out
            leaf = w.T.reshape(shape)
        else:
            leaf = w.reshape(shape)
        if not np.array_equal(fn(leaf), w):
            raise ValueError(f"cannot invert the mapping of {path}")
        node = tree
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = np.ascontiguousarray(leaf, dtype=np.float32)
    return {"params": tree}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dim", type=int, default=1024)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--t_depth", type=int, default=12)
    p.add_argument("--c_depth", type=int, default=8)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--steps", type=int, default=50, help="DDIM grid points")
    p.add_argument("--timesteps", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--threads", type=int, default=4)
    args = p.parse_args(argv)
    torch.set_num_threads(args.threads)

    torch.manual_seed(args.seed)
    model = ProtNet(dim=args.dim, heads=args.heads, t_depth=args.t_depth,
                    c_depth=args.c_depth, **FLAGS).eval()
    cfg = dict(dim=args.dim, heads=args.heads, t_depth=args.t_depth, c_depth=args.c_depth,
               share_encoders=True, fused_qkv=False, **FLAGS)
    shapes, mapping = convert._protnet_tables(cfg)
    params = flax_tree_from_port(model.state_dict(), shapes, mapping)
    print(f"ProtNet params: {sum(int(np.prod(s)) for s in shapes.values())}", flush=True)

    rng = np.random.default_rng(args.seed)
    batch_np = j_pad([j_pair(rng) for _ in range(args.batch)])
    gen = torch.Generator().manual_seed(args.seed + 1)
    x_t = AffineT(haar_rotations(gen, (args.batch,)), torch.randn(args.batch, 3, generator=gen))
    x_j = jse3.AffineT(jnp.asarray(x_t.rot.numpy()), jnp.asarray(x_t.shift.numpy()))

    jm = JProtNet(dim=args.dim, heads=args.heads, t_depth=args.t_depth, c_depth=args.c_depth,
                  **FLAGS)
    jproc, tproc = JProc(args.timesteps), ProjectedSE3Diffusion(args.timesteps, device="cpu")
    jproj, tproj = JProj(batch_np), ProtProjection(to_device(batch_np, "cpu"))
    jstep = jax.jit(lambda p, x, t, tp: jproc._ddim_map(lambda a, b: jm.apply(p, a, b), x, t, tp,
                                                         jproj))
    grid = _linspace_grid(args.timesteps, args.steps)
    rows, first = [], {"jax": None, "port": None}
    for i in range(args.steps):
        t0 = time.perf_counter()
        jt = jnp.full((args.batch,), grid[i], jnp.int32)
        jtp = jnp.full((args.batch,), grid[i + 1], jnp.int32)
        x_j = jstep(params, x_j, jt, jtp)
        with torch.inference_mode():
            x_t = tproc._ddim_map(model, x_t, torch.full((args.batch,), grid[i]),
                                  torch.full((args.batch,), grid[i + 1]), tproj)
        js, ts = np.asarray(x_j.shift), x_t.shift.numpy()
        row = {"step": i + 1, "t": grid[i + 1],
               "jax_shift_max": float(np.abs(js).max()), "port_shift_max": float(np.abs(ts).max()),
               "seconds": time.perf_counter() - t0}
        for name, s in (("jax", js), ("port", ts)):
            if first[name] is None and not np.isfinite(s).all():
                first[name] = i + 1
        rows.append(row)
        print(json.dumps(row), flush=True)
        if first["jax"] is not None and first["port"] is not None:
            break
    result = {"first_non_finite_step": first, "batch": args.batch, "dim": args.dim,
              "steps_run": len(rows)}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
