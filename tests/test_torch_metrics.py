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


# ---------------------------------------------------------------------------
# The CUDA kernel's arithmetic (octant-reduced atan polynomial, exp2) in
# plain PyTorch
# ---------------------------------------------------------------------------

def _theta_sweep(axis, m=4096):
    """One X and m rotations X exp(theta axis), theta dense on [0, pi] with
    both ends (float64, then cast)."""
    theta = np.linspace(0.0, np.pi, m)
    axis = np.array(axis, dtype=np.float64)
    axis /= np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    rel = (np.eye(3) + np.sin(theta)[:, None, None] * k
           + (1 - np.cos(theta))[:, None, None] * (k @ k))
    x = _rots(21, 1).astype(np.float64)
    return theta, x.astype(np.float32), (x @ rel).astype(np.float32)


@pytest.mark.parametrize("case", ["300x200", "257x130", "X=Y", "pi pairs", "1x1", "one column",
                                  "tile plus one", "small angles"])
def test_kernel_terms_ref_matches_pallas_xla_and_plain(case, pairs):
    """The kernel's formulas (bilinears split three ways in TF32 as on the
    tensor cores) against the Pallas kernel (interpret mode), the XLA sum
    and the port's plain version: rtol 1e-4 on the sum, the kernel's gate,
    and 2e-6 term by term against the plain matrix."""
    x, y = {"300x200": (_rots(300, 300), _rots(207, 200, 0.3)),
            "257x130": (_rots(257, 257), _rots(137, 130, 0.3)),
            "X=Y": (_rots(5, 200),) * 2,
            "pi pairs": pairs,
            "1x1": (_rots(1, 1), _rots(2, 1)),
            "one column": (_rots(15, 133), _rots(16, 1)),
            "tile plus one": (_rots(17, 129), _rots(18, 513, 0.3)),
            "small angles": (_rots(19, 40, 1e-3), _rots(20, 30, 1e-3))}[case]
    terms = mmd_cuda.kernel_terms_ref(_t(x), _t(y))
    assert terms.shape == (x.shape[0], y.shape[0]) and terms.dtype == torch.float32
    plain = mmd_cuda.gaussian_kernel_matrix(_t(x), _t(y))
    np.testing.assert_allclose(terms, plain, rtol=2e-6, atol=2e-7)
    pallas = float(gaussian_kernel_sum_pallas(jnp.asarray(x), jnp.asarray(y), interpret=True))
    xla = float(jnp.sum(jm.gaussian_kernel_matrix(jnp.asarray(x), jnp.asarray(y))))
    for ref in (pallas, xla, float(plain.sum())):
        np.testing.assert_allclose(float(terms.sum()), ref, rtol=1e-4)


@pytest.mark.parametrize("axis", [(0.3, -0.5, 0.81), (0.0, 0.0, 1.0)], ids=["oblique", "z"])
def test_kernel_terms_ref_theta_sweep(axis):
    """Every octant of the reduced atan2 and both selects: each term within
    2e-6 of exp(-sqrt(2) theta) in float64, the sum within rtol 1e-5, and the
    MMD built on these terms within the MMD's gate of the JAX MMD."""
    theta, x, y = _theta_sweep(axis)
    terms = mmd_cuda.kernel_terms_ref(_t(x), _t(y))[0].numpy()
    want = np.exp(-np.sqrt(2.0) * theta)
    np.testing.assert_allclose(terms, want, rtol=2e-6, atol=2e-7)
    np.testing.assert_allclose(terms.sum(dtype=np.float64), want.sum(), rtol=1e-5)
    a, b = _rots(50, 200), _rots(51, 150, 0.3)
    ours = mmd_cuda.biased_mmd(
        lambda p, q: mmd_cuda.kernel_terms_ref(p, q).sum(), _t(a), _t(b))
    ref = float(jm.mmd(jnp.asarray(a), jnp.asarray(b), jm.gaussian_kernel_matrix))
    np.testing.assert_allclose(float(ours), ref, rtol=1e-3, atol=1e-5)


def test_kernel_source_holds_the_atan_polynomial():
    """kAtan0..kAtan7 of csrc/gaussian_kernel_sum.cu are ATAN_POLY, and the
    polynomial is within 2e-7 rad of atan on [0, 1] in float32."""
    import re

    src = mmd_cuda.SOURCE.read_text()
    consts = dict(re.findall(r"constexpr float (kAtan\d) = ([-+.\deE]+)f;", src))
    assert [float(consts[f"kAtan{i}"]) for i in range(8)] == list(mmd_cuda.ATAN_POLY)
    assert "atomicAdd" not in src
    z = torch.linspace(0.0, 1.0, 100_001)
    p = torch.full_like(z, mmd_cuda.ATAN_POLY[-1])
    for coef in mmd_cuda.ATAN_POLY[-2::-1]:
        p = p * (z * z) + coef
    err = (p * z).double() - torch.atan(z.double())
    assert float(err.abs().max()) < 2e-7


def test_tensor_core_features_give_the_four_bilinears(pairs):
    """sum_k Fx[n, s, k] Fy[m, s, k] is the trace's first eight products and
    the three skew components of X^T Y (the plain version's and JAX's
    pairwise angle follows from them); split three ways in TF32 each
    bilinear stays within 1e-6."""
    x, y = _t(pairs[0]), _t(pairs[1])
    fx, fy = mmd_cuda.tensor_core_features(x, True), mmd_cuda.tensor_core_features(y, False)
    assert fx.shape == (64, 4, 8) and fy.shape == (64, 4, 8)
    bil = torch.einsum("nsk,msk->snm", fx.double(), fy.double())
    g = torch.einsum("nrp,mrq->nmpq", x.double(), y.double())  # X^T Y per pair
    want = torch.stack([torch.einsum("nmpp->nm", g) - x[:, 2, 2, None].double() * y[None, :, 2, 2],
                        g[..., 2, 1] - g[..., 1, 2], g[..., 0, 2] - g[..., 2, 0],
                        g[..., 1, 0] - g[..., 0, 1]])
    np.testing.assert_allclose(bil, want, rtol=0, atol=1e-12)
    theta = torch.atan2(0.5 * torch.linalg.norm(bil[1:], dim=0),
                        0.5 * (bil[0] + x[:, 2, 2, None] * y[None, :, 2, 2] - 1.0))
    ref = np.asarray(jm.pairwise_rotation_angle(jnp.asarray(pairs[0]), jnp.asarray(pairs[1])))
    np.testing.assert_allclose(theta, ref, rtol=0, atol=1e-5)
    (xh, xl), (yh, yl) = mmd_cuda.split_tf32(fx), mmd_cuda.split_tf32(fy)
    assert float((fx - xh - xl).abs().max()) <= 2.0**-21
    assert int((xh.view(torch.int32) & 0x1FFF).abs().max()) == 0  # 10 mantissa bits
    split = sum(torch.einsum("nsk,msk->snm", a.double(), b.double())
                for a, b in ((xh, yl), (xl, yh), (xh, yh)))
    np.testing.assert_allclose(split, want, rtol=0, atol=1e-6)
