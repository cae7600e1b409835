"""Which float32 ProtNet gradient is off: JAX's or the port's.

The dim-32 ProtNet of ``test_torch_se3_process.py`` (heads 2, t_depth 2,
c_depth 3, frame_pool, cross_depth 1, rel_frame, equiv_head; output layer
scaled by 0.1), its grad_mse loss at fixed t and noise, differentiated five
ways: JAX in float32 op by op (``jax.grad`` without ``jit``, as
``test_torch_se3_process.py`` takes it) and under ``jit``, JAX in float64 (``jax.enable_x64(True)``, which
replaced ``jax.experimental.enable_x64``, scoped to the test; float64
weights, batch and noise), the port in float32 and the port in float64.  The JAX package casts activations to float32 by
name (``jnp.float32`` in its layers and ProtNet); for the float64 run the
test points those modules' ``jnp`` at a proxy whose ``float32`` is float64,
so every activation is float64 (nothing in the package is edited).  The two
float64 gradients agree to 1e-7 of each leaf's scale (measured 2.0e-8), so
either is the reference; each float32 gradient is held against JAX's
float64 one, leaf by leaf, relative to that leaf's largest entry.  The key
biases, whose gradient is zero in exact arithmetic, are held to the
model's largest entry instead.  Measured: the port's float32 and JAX's
jitted float32 within 1.1e-5 of every leaf; JAX's op-by-op float32 3.9e-2
off in the ligand cross layer's first feed-forward weight
(``cross.1.ff1``), 1.7e-3 to 3.2e-2 across that layer.  So the ~4e-3 gap
between the port and JAX that the SE(3) gradient test records is JAX's
op-by-op evaluation, not float32 and not the port.
"""
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffusion_extensions_tpu.data.pdb import pad_prot_batch as j_pad
from diffusion_extensions_tpu.data.pdb import synthetic_prot_pair as j_pair
from diffusion_extensions_tpu.models import layers as jlayers
from diffusion_extensions_tpu.models import protnet as jprotnet
from diffusion_extensions_tpu.models.projections import ProtProjection as JProj
from diffusion_extensions_tpu.ops import se3 as jse3
from diffusion_extensions_tpu.ops.so3 import log_rmat_vec
from diffusion_extensions_tpu.processes.se3 import ProjectedSE3Diffusion as JProc
from diffusion_extensions_tpu_torch import convert
from diffusion_extensions_tpu_torch.data.pdb import to_device
from diffusion_extensions_tpu_torch.models.projections import ProtProjection
from diffusion_extensions_tpu_torch.models.protnet import ProtNet
from diffusion_extensions_tpu_torch.ops.se3 import AffineT
from diffusion_extensions_tpu_torch.processes.se3 import ProjectedSE3Diffusion

torch.set_num_threads(1)
T, B = 20, 3
FLAGS = dict(frame_pool=True, cross_depth=1, rel_frame=True, equiv_head=True)


def _jax_loss(model, proc):
    """grad_mse of ``SE3Diffusion.p_losses`` with the noise passed in (its
    ``p_losses`` draws it from a key), in the inputs' dtype."""

    def loss(params, batch, t, noise_rot, noise_shift):
        b = noise_rot.shape[0]
        eps = proc.schedule.sqrt_one_minus_alphas_cumprod[t][:, None].astype(noise_shift.dtype)
        truth = jse3.AffineT(jnp.broadcast_to(jnp.eye(3, dtype=noise_rot.dtype), (b, 3, 3)),
                             jnp.zeros((b, 3), noise_shift.dtype))
        x_noisy = proc.q_sample(truth, t, jse3.AffineT(noise_rot, noise_shift))
        out = model.apply(params, JProj(batch)(x_noisy), t)
        d_shift = noise_shift / (eps * proc.shift_scale)
        d_rot = log_rmat_vec(noise_rot) / eps
        return jnp.mean((out.shift_g - d_shift) ** 2) + jnp.mean((out.rot_g - d_rot) ** 2)

    return loss


def _cast(tree, dtype):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, dtype) if np.issubdtype(np.asarray(a).dtype, np.floating)
        else np.asarray(a), tree)


def _to_port(tree, mapping):
    """A flax gradient tree -> port names, float64 numpy, port layouts."""
    leaves = convert._flatten(convert._unwrap(tree))
    return {key: np.asarray(fn(np.asarray(leaves[path], np.float64)))
            for path, (key, fn) in mapping.items()}


@pytest.fixture(scope="module")
def grads():
    rng = np.random.default_rng(0)
    batch = j_pad([j_pair(rng, 14 - 2 * i, 8 - i) for i in range(B)])
    jm = jprotnet.ProtNet(dim=32, heads=2, t_depth=2, c_depth=3, **FLAGS)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), batch, jnp.zeros((B,), jnp.int32)))
    out = max((k for k in params["params"] if k.startswith("Dense_")),
              key=lambda k: int(k.split("_")[1]))
    head = params["params"][out]
    head["kernel"], head["bias"] = head["kernel"] * 0.1, head["bias"] * 0.1
    jproc = JProc(T)
    k_t, k_n = jax.random.split(jax.random.PRNGKey(10))
    t = jax.random.randint(k_t, (B,), 0, T)
    noise = jproc.sample_noise(k_n, t)
    nrot, nshift = np.array(noise.rot), np.array(noise.shift)
    cfg = convert.protnet_config_from_flax(params)
    _, mapping = convert._protnet_tables(cfg)

    loss = _jax_loss(jm, jproc)
    key = jax.random.PRNGKey(10)
    truth = jse3.AffineT(jnp.broadcast_to(jnp.eye(3), (B, 3, 3)), jnp.zeros((B, 3)))
    same = float(jproc.loss(lambda x, tt: jm.apply(params, x, tt), key, truth, JProj(batch)))
    value32 = float(loss(params, batch, t, nrot, nshift))
    out = {"loss_matches_the_process": (value32, same)}
    out["jax32"] = _to_port(jax.jit(jax.grad(loss))(params, batch, t, nrot, nshift), mapping)
    out["jax32_eager"] = _to_port(jax.grad(loss)(params, batch, t, nrot, nshift), mapping)

    proxy = types.SimpleNamespace(**{n: getattr(jnp, n) for n in dir(jnp) if not n.startswith("__")})
    proxy.float32 = jnp.float64
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jlayers, "jnp", proxy)
        mp.setattr(jprotnet, "jnp", proxy)
        with jax.enable_x64(True):
            g64 = jax.jit(jax.grad(loss))(_cast(params, np.float64), _cast(batch, np.float64),
                                 jnp.asarray(np.asarray(t)), nrot.astype(np.float64),
                                 nshift.astype(np.float64))
            leaves = jax.tree_util.tree_leaves(g64)
            assert all(leaf.dtype == jnp.float64 for leaf in leaves)
            out["jax64"] = _to_port(g64, mapping)
    finally:
        mp.undo()

    tt = torch.from_numpy(np.array(t)).long()
    state = convert.protnet_params_from_flax(params)
    for name, dtype in (("port32", torch.float32), ("port64", torch.float64)):
        model = ProtNet(**cfg)
        model.load_state_dict(state)
        model = model.to(dtype)
        tb = to_device(batch, "cpu")
        if dtype == torch.float64:
            tb = type(tb)(*[type(f)(*[v.double() if v.is_floating_point() else v for v in f])
                            if isinstance(f, tuple) else f for f in tb])
        proc = ProjectedSE3Diffusion(T, device="cpu")
        nz = AffineT(torch.from_numpy(nrot).to(dtype), torch.from_numpy(nshift).to(dtype))
        proc.loss(model, None, AffineT.identity((B,), dtype=dtype), ProtProjection(tb),
                  t=tt, noise=nz).backward()
        out[name] = {n: p.grad.double().numpy() for n, p in model.named_parameters()}
    return out


def _leaf_errors(got: dict, want: dict) -> dict:
    return {n: float(np.abs(got[n] - want[n]).max()) / max(float(np.abs(want[n]).max()), 1e-30)
            for n in want}


def test_the_explicit_loss_is_the_process_loss(grads):
    value, same = grads["loss_matches_the_process"]
    np.testing.assert_allclose(value, same, rtol=1e-6)


def test_the_two_float64_gradients_agree(grads):
    """JAX's float64 gradient and the port's: 1e-7 of each leaf's largest
    entry (leaves whose exact gradient is zero, the key biases, aside)."""
    errs = _leaf_errors(grads["port64"], grads["jax64"])
    scale = max(float(np.abs(g).max()) for g in grads["jax64"].values())
    for name, err in errs.items():
        if "key.bias" in name:
            assert np.abs(grads["port64"][name]).max() < 1e-12 * scale, name
        else:
            assert err < 1e-7, (name, err)


@pytest.mark.parametrize("which", ["port32", "jax32"])
def test_float32_gradient_is_within_2e_5_of_float64(grads, which):
    """Every leaf of the port's float32 gradient, and of JAX's under jit,
    within 2e-5 of that leaf's largest float64 entry (the key biases: 1e-6
    of the model's largest)."""
    errs = _leaf_errors(grads[which], grads["jax64"])
    scale = max(float(np.abs(g).max()) for g in grads["jax64"].values())
    for name, err in errs.items():
        if "key.bias" in name:
            assert np.abs(grads[which][name]).max() < 1e-6 * scale, name
        else:
            assert err < 2e-5, (name, err)


def test_jax_op_by_op_float32_gradient_is_the_one_off(grads):
    """JAX's op-by-op float32 gradient parts from float64 where the port's
    and JAX's jitted one do not: its worst leaf is in the ligand's
    cross-attention layer (``cross.1``), between 1e-3 and 1e-1 of that
    leaf's scale (measured 3.9e-2), over 100 times the port's error on the
    same leaf (measured 1.1e-6)."""
    jax_errs = _leaf_errors(grads["jax32_eager"], grads["jax64"])
    port_errs = _leaf_errors(grads["port32"], grads["jax64"])
    worst = max((n for n in jax_errs if "key.bias" not in n), key=jax_errs.get)
    assert worst.startswith("cross.1."), (worst, jax_errs[worst])
    assert 1e-3 < jax_errs[worst] < 1e-1, (worst, jax_errs[worst])
    assert jax_errs[worst] > 100 * port_errs[worst], (worst, jax_errs[worst], port_errs[worst])
