"""The library functions the diagnostics slice adds to the port, against the
JAX package's, on the CPU: ``IGSO3xR3`` (log_prob to the kernel's gates,
its draws by distribution), ``igso3_log_prob_haar``, the reference-exact
table sampler ``IGSO3Table.sample_angles_exact`` fed JAX's uniforms,
``so3_bezier``, ``haar_rotations_proper``, ``AffineT.from_euler`` and
``ResLayer``.  Randomness is never shared by seed: the parity tests feed
both sides the same numbers, the samplers are held by their distribution.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as fnn

from diffusion_extensions_tpu.models.layers import ResLayer as JResLayer
from diffusion_extensions_tpu.ops import igso3 as jig
from diffusion_extensions_tpu.ops import se3 as jse3
from diffusion_extensions_tpu.ops import so3 as jso3
from diffusion_extensions_tpu_torch.models.layers import ResLayer, dense
from diffusion_extensions_tpu_torch.ops import igso3 as tig
from diffusion_extensions_tpu_torch.ops.se3 import AffineT
from diffusion_extensions_tpu_torch.ops.so3 import (
    exp_skewvec,
    haar_rotations_proper,
    rotation_angle,
    so3_bezier,
)

torch.set_num_threads(1)
LOGF_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_pallas.py's log f gate


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _poses(rng, n, scale=1.0):
    rot = np.asarray(jso3.exp_skewvec(jnp.asarray(rng.standard_normal((n, 3)) * scale,
                                                  jnp.float32)))
    return rot, (rng.standard_normal((n, 3)) * 3.0).astype(np.float32)


@pytest.mark.parametrize("shift_scale", [1.0, 75.0])
def test_igso3xr3_log_prob_matches_jax(shift_scale):
    """Per-pose eps, a mean pose and values near and far from it."""
    rng = np.random.default_rng(0)
    n = 257
    eps = rng.uniform(0.03, 1.4, n).astype(np.float32)
    mean_rot, mean_shift = _poses(rng, n)
    val_rot, val_shift = _poses(rng, n, scale=0.7)
    val_shift = val_shift * shift_scale * 0.2
    ref = jig.IGSO3xR3.create(jnp.asarray(eps), jse3.AffineT(jnp.asarray(mean_rot),
                                                             jnp.asarray(mean_shift)),
                              shift_scale=shift_scale)
    want = np.asarray(ref.log_prob(jse3.AffineT(jnp.asarray(val_rot), jnp.asarray(val_shift))))
    ours = tig.IGSO3xR3.create(eps, AffineT(_t(mean_rot), _t(mean_shift)),
                               shift_scale=shift_scale, device="cpu")
    got = ours.log_prob(AffineT(_t(val_rot), _t(val_shift)))
    assert got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), want, **LOGF_TOL)
    # the default mean is the identity pose
    d = tig.IGSO3xR3.create(eps[:4], device="cpu")
    assert torch.equal(d.mean_shift, torch.zeros(4, 3))
    assert torch.equal(d.igso3.mean, torch.eye(3))


def test_igso3xr3_sample_distribution():
    """20,000 draws about a mean pose: the angle of mean^T R against the
    table's CDF (Kolmogorov-Smirnov distance < 0.015), the shift's mean and
    standard deviation against mean.shift and eps * shift_scale; the draws
    replay from the generator's seed."""
    n, eps, scale = 20_000, 0.4, 75.0
    mean_rot = exp_skewvec(torch.tensor([0.3, -1.1, 0.5]))
    mean = AffineT(mean_rot, torch.tensor([1.0, -2.0, 3.0]))
    dist = tig.IGSO3xR3.create(eps, mean=mean, shift_scale=scale, device="cpu")
    x = dist.sample(torch.Generator().manual_seed(0), (n,))
    assert x.rot.shape == (n, 3, 3) and x.shift.shape == (n, 3)
    theta = rotation_angle(mean_rot.T @ x.rot).sort().values
    table = tig.IGSO3Table.from_eps([eps], device="cpu")
    cdf = table.cdf_angles(theta, torch.zeros(n, dtype=torch.long))
    emp = torch.arange(1, n + 1) / n
    assert float((cdf - emp).abs().max()) < 0.015
    np.testing.assert_allclose(x.shift.mean(0).numpy(), [1.0, -2.0, 3.0], atol=4 * eps * scale
                               / n ** 0.5)
    np.testing.assert_allclose(x.shift.std(0).numpy(), eps * scale, rtol=0.03)
    again = dist.sample(torch.Generator().manual_seed(0), (n,))
    assert torch.equal(again.rot, x.rot) and torch.equal(again.shift, x.shift)


def test_log_prob_haar_matches_jax():
    """Against JAX wherever its Haar factor (1 - cos t) / pi is a normal
    float32; below that both clamp it at 1e-38, a subnormal that XLA on the
    CPU flushes to zero (JAX: -inf), while torch keeps it (the port: the
    finite log(1e-38) + log f, as the clamp means)."""
    rng = np.random.default_rng(1)
    t = rng.uniform(0.0, np.pi, 999).astype(np.float32)
    t[:3] = [0.0, 1e-6, np.float32(np.pi)]
    s = rng.uniform(0.02, 1.5, 999).astype(np.float32)
    want = np.asarray(jig.igso3_log_prob_haar(jnp.asarray(t), jnp.asarray(s)))
    got = tig.igso3_log_prob_haar(_t(t), _t(s)).numpy()
    normal = (1.0 - np.cos(t)) / np.float32(np.pi) >= np.finfo(np.float32).tiny
    assert (~normal).sum() == 2 and np.isneginf(want[~normal]).all()
    np.testing.assert_allclose(got[normal], want[normal], **LOGF_TOL)
    logf = tig.igso3_log_density(_t(t[:2]), _t(s[:2])).numpy()
    np.testing.assert_allclose(got[:2], logf + np.log(np.float32(1e-38)), rtol=1e-6)


def test_sample_angles_exact_with_jax_uniforms():
    """JAX's own uniforms through both tables' exact bracketing: the angles
    JAX's ``_angles_from_unif`` gives (1e-6), and the rows the indices pick."""
    eps = np.array([0.01, 0.1, 0.5, 1.0, 1.7], np.float32)
    jt, tt = jig.IGSO3Table.from_eps(eps), tig.IGSO3Table.from_eps(eps, device="cpu")
    idx = np.random.default_rng(2).integers(0, len(eps), (7, 33))
    unif = jax.random.uniform(jax.random.PRNGKey(3), idx.shape)
    want = np.asarray(jig._angles_from_unif(unif, jt.trap_locs, jt.cdf[jnp.asarray(idx)]))
    got = tt.sample_angles_exact(None, torch.from_numpy(idx), unif=_t(unif))
    assert got.shape == idx.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # and JAX's own exact sampler, from the key its uniforms came from
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jt.sample_angles_exact(jax.random.PRNGKey(3), jnp.asarray(idx))),
        rtol=1e-6, atol=1e-6)


def test_sample_angles_exact_agrees_with_the_quantile_table():
    """Drawn from a generator, the exact sampler and the quantile-table
    sampler give the same distribution (KS distance < 0.02 at 20,000)."""
    table = tig.IGSO3Table.from_eps([0.05, 0.6], device="cpu")
    idx = torch.ones(20_000, dtype=torch.long)
    exact = table.sample_angles_exact(torch.Generator().manual_seed(4), idx).sort().values
    fast = table.sample_angles(torch.Generator().manual_seed(5), idx).sort().values
    grid = torch.linspace(0.0, np.pi, 400)
    cdf_e = torch.searchsorted(exact, grid) / len(exact)
    cdf_f = torch.searchsorted(fast, grid) / len(fast)
    assert float((cdf_e - cdf_f).abs().max()) < 0.02


@pytest.mark.parametrize("n_ctrl", [2, 3, 4])
def test_so3_bezier_matches_jax(n_ctrl):
    rng = np.random.default_rng(n_ctrl)
    ctrl = [np.asarray(jso3.exp_skewvec(jnp.asarray(rng.standard_normal((6, 3)), jnp.float32)))
            for _ in range(n_ctrl)]
    w = rng.uniform(0, 1, (6, 1)).astype(np.float32)
    want = np.asarray(jso3.so3_bezier([jnp.asarray(c) for c in ctrl], jnp.asarray(w)))
    got = so3_bezier([_t(c) for c in ctrl], _t(w)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)
    # the ends are the first and last control rotations
    ends = so3_bezier([_t(c) for c in ctrl], torch.tensor([[0.0], [1.0]] * 3)).numpy()
    np.testing.assert_allclose(ends[0], ctrl[0][0], atol=2e-6)
    np.testing.assert_allclose(ends[1], ctrl[-1][1], atol=2e-6)


def test_haar_rotations_proper_is_special_orthogonal_and_haar():
    """det +1 and orthonormal to float32; the trace's mean 0 and the angle
    CDF (theta - sin theta) / pi of the Haar measure on SO(3)."""
    q = haar_rotations_proper(torch.Generator().manual_seed(6), (20_000,))
    assert q.shape == (20_000, 3, 3)
    np.testing.assert_allclose(torch.linalg.det(q).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose((q.transpose(-1, -2) @ q).numpy(),
                               np.broadcast_to(np.eye(3), q.shape), atol=1e-5)
    tr = q.diagonal(dim1=-2, dim2=-1).sum(-1)
    assert abs(float(tr.mean())) < 0.03
    theta = rotation_angle(q).sort().values
    haar_cdf = (theta - torch.sin(theta)) / np.pi
    assert float((haar_cdf - torch.arange(1, 20_001) / 20_000).abs().max()) < 0.015
    # the shape argument and the generator's device, as haar_rotations takes them
    assert haar_rotations_proper(None, (2, 5)).shape == (2, 5, 3, 3)


def test_affine_from_euler_matches_jax():
    rng = np.random.default_rng(7)
    euls = rng.uniform(-np.pi, np.pi, (9, 3)).astype(np.float32)
    shift = rng.standard_normal((9, 3)).astype(np.float32)
    want = jse3.AffineT.from_euler(jnp.asarray(euls), jnp.asarray(shift))
    got = AffineT.from_euler(_t(euls), _t(shift))
    np.testing.assert_allclose(got.rot.numpy(), np.asarray(want.rot), atol=1e-6)
    assert torch.equal(got.shift, _t(shift))


def test_res_layer_matches_flax():
    """x + layer(x) with a Dense layer of flax's weights."""
    x = np.random.default_rng(8).standard_normal((4, 16)).astype(np.float32)
    mod = JResLayer(layer=fnn.Dense(16))
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(mod.apply(params, jnp.asarray(x)))
    lin = dense(16, 16)
    p = params["params"]["layer"]
    with torch.no_grad():
        lin.weight.copy_(_t(np.asarray(p["kernel"]).T))
        lin.bias.copy_(_t(p["bias"]))
    got = ResLayer(lin)(_t(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
