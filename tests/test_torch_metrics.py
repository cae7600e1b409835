"""The port's rotation metrics, kernels and MMD against the JAX package's,
on the CPU.

Inputs are numpy arrays from fixed seeds, fed to both sides.  The
elementwise functions agree to rtol 1e-5 / atol 1e-6 (float32, different
math libraries); the pairwise angle to 1e-5 absolute (atan2 of matmul
outputs summed in another order); the kernel sums to rtol 1e-4 and the MMD
to rtol 1e-3 / atol 1e-5, the gates of tests/test_pallas.py.  The JAX Pallas
kernel runs in interpret mode, as its own tests run it.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from diffusion_extensions_tpu.ops import metrics as jm
from diffusion_extensions_tpu.ops import so3 as jso3
from diffusion_extensions_tpu.ops.mmd_pallas import gaussian_kernel_sum_pallas, mmd_pallas
from diffusion_extensions_tpu_torch.ops import metrics as tm
from diffusion_extensions_tpu_torch.ops import mmd_cuda

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _rots(seed, n, scale=1.0):
    v = np.random.default_rng(seed).standard_normal((n, 3)).astype(np.float32) * scale
    return np.array(jso3.exp_skewvec(jnp.asarray(v)))


def _pi_rotations(seed, n):
    """Exact rotations by pi, 2 u u^T - I for unit axes u (float64, then
    cast), including the three coordinate axes."""
    u = np.random.default_rng(seed).standard_normal((n, 3))
    u[:3] = np.eye(3)
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    return (2.0 * u[:, :, None] * u[:, None, :] - np.eye(3)).astype(np.float32)


@pytest.fixture(scope="module")
def pairs():
    """64 (X, Y) pairs: random, identity pairs (Y = X) and exact-pi
    relative rotations (Y = X P with P a rotation by pi)."""
    x = _rots(0, 64)
    y = _rots(1, 64, 0.7)
    y[:8] = x[:8]
    y[8:24] = np.matmul(x[8:24].astype(np.float64), _pi_rotations(2, 16)).astype(np.float32)
    return x, y


@pytest.mark.parametrize(
    "name", ["rmat_cosine_dist", "rmat_cosine_kernel", "rmat_dist", "rmat_gaussian_kernel"]
)
def test_elementwise_metrics_match_jax(pairs, name):
    x, y = pairs
    ref = np.asarray(getattr(jm, name)(jnp.asarray(x), jnp.asarray(y)))
    ours = getattr(tm, name)(_t(x), _t(y)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)


def test_elementwise_metrics_at_identity_and_pi(pairs):
    """theta = 0 on the identity pairs, pi on the exact-pi pairs."""
    x, y = _t(pairs[0]), _t(pairs[1])
    d = tm.rmat_dist(x, y).numpy()
    np.testing.assert_allclose(d[:8], 0.0, atol=1e-3)
    np.testing.assert_allclose(d[8:24], np.sqrt(2.0) * np.pi, rtol=1e-5)
    np.testing.assert_allclose(tm.rmat_cosine_kernel(x, y).numpy()[8:24], -1.0, atol=1e-6)


def test_pairwise_angle_and_kernel_matrices_match_jax(pairs):
    x, y = pairs
    ja, jb = jnp.asarray(x), jnp.asarray(y)
    ref = np.asarray(jm.pairwise_rotation_angle(ja, jb))
    ours = tm.pairwise_rotation_angle(_t(x), _t(y)).numpy()
    assert ours.shape == (64, 64)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    # the diagonal pairs: identity and exact pi
    np.testing.assert_allclose(np.diag(ours)[8:24], np.pi, atol=1e-5)
    for name in ("gaussian_kernel_matrix", "cosine_kernel_matrix"):
        np.testing.assert_allclose(getattr(tm, name)(_t(x), _t(y)).numpy(),
                                   np.asarray(getattr(jm, name)(ja, jb)),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,m", [(300, 200), (257, 130)])
def test_kernel_sum_ref_matches_pallas_and_xla(n, m):
    """The port's plain version against the Pallas kernel (interpret mode)
    and against jnp.sum(gaussian_kernel_matrix); 257 x 130 is the masking
    case of tests/test_pallas.py."""
    x, y = _rots(n, n), _rots(m + 7, m, 0.3)
    pallas = float(gaussian_kernel_sum_pallas(jnp.asarray(x), jnp.asarray(y), interpret=True))
    xla = float(jnp.sum(jm.gaussian_kernel_matrix(jnp.asarray(x), jnp.asarray(y))))
    ours = mmd_cuda.gaussian_kernel_sum_ref(_t(x), _t(y))
    np.testing.assert_allclose(float(ours), pallas, rtol=1e-4)
    np.testing.assert_allclose(float(ours), xla, rtol=1e-4)
    # the wrapper takes the plain version for CPU tensors, launching nothing
    before = mmd_cuda.launches
    assert float(mmd_cuda.gaussian_kernel_sum(_t(x), _t(y))) == float(ours)
    assert mmd_cuda.launches == before
    assert mmd_cuda._lib is None  # nothing was built


def test_mmd_and_mmd_cuda_match_jax():
    x, y = _rots(10, 200), _rots(11, 200, 0.3)
    ref = float(jm.mmd(jnp.asarray(x), jnp.asarray(y), jm.gaussian_kernel_matrix))
    ref_pallas = float(mmd_pallas(jnp.asarray(x), jnp.asarray(y), interpret=True))
    for ours in (tm.mmd(_t(x), _t(y)), mmd_cuda.mmd_cuda(_t(x), _t(y))):
        np.testing.assert_allclose(float(ours), ref, rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(float(ours), ref_pallas, rtol=1e-3, atol=1e-5)
    ref_cos = float(jm.mmd(jnp.asarray(x), jnp.asarray(y), jm.cosine_kernel_matrix))
    np.testing.assert_allclose(float(tm.mmd(_t(x), _t(y), tm.cosine_kernel_matrix)),
                               ref_cos, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("kernel", ["gaussian_kernel_matrix", "cosine_kernel_matrix"])
def test_chunked_equals_unchunked(kernel):
    x, y = _rots(20, 130), _rots(21, 70, 0.5)
    km = getattr(tm, kernel)
    whole = float(tm.mmd(_t(x), _t(y), km))
    for chunk in (16, 64, 100):
        np.testing.assert_allclose(float(tm.mmd(_t(x), _t(y), km, chunksize=chunk)), whole,
                                   rtol=1e-5, atol=1e-7)
    # and against JAX's chunked loop
    ref = float(jm.mmd(jnp.asarray(x), jnp.asarray(y), getattr(jm, kernel), chunksize=64))
    np.testing.assert_allclose(whole, ref, rtol=1e-3, atol=1e-5)


def test_two_sample_tests_match_jax():
    """Same distribution (accepted) and different distributions (refused),
    equal on both sides; unequal counts raise."""
    same_x, same_y = _rots(30, 400, 0.2), _rots(31, 400, 0.2)
    diff_y = _rots(32, 400, 2.0)
    for x, y in ((same_x, same_y), (same_x, diff_y)):
        jx, jy = jnp.asarray(x), jnp.asarray(y)
        assert tm.ker_2samp_test(_t(x), _t(y)) == jm.ker_2samp_test(jx, jy)
        np.testing.assert_allclose(tm.ker_2samp_log_prob(_t(x), _t(y), chunksize=128),
                                   jm.ker_2samp_log_prob(jx, jy, chunksize=128),
                                   rtol=1e-3, atol=1e-4)
    assert tm.ker_2samp_test(_t(same_x), _t(same_y))
    assert not tm.ker_2samp_test(_t(same_x), _t(diff_y))
    with pytest.raises(ValueError):
        tm.ker_2samp_test(_t(same_x), _t(same_y[:10]))


def test_mmd_refuses_mixed_devices_before_any_launch():
    """A CPU/non-CPU mix with the Gaussian kernel reaches the kernel's
    wrapper, which refuses it (no plain fallback)."""
    x = _t(_rots(40, 4))
    with pytest.raises(ValueError):
        mmd_cuda.gaussian_kernel_sum(x, x.to("meta"))
    with pytest.raises(ValueError):
        tm.mmd(x, x.to("meta"))
