"""The port's IGSO(3) density, score, tables and kernel wrapper against the
JAX package's, on the CPU (where the wrapper takes its plain version).

Gates for the log-density/score pair are those of ``tests/test_pallas.py``:
log f at rtol = atol = 1e-5; the score at rtol 1e-4, atol 5e-4.
"""
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from diffusion_extensions_tpu.ops import igso3 as jig
from diffusion_extensions_tpu.ops import so3 as jso3
from diffusion_extensions_tpu.ops.igso3_pallas import igso3_logpdf_score_pallas
from diffusion_extensions_tpu_torch import obs
from diffusion_extensions_tpu_torch.ops import igso3 as tig
from diffusion_extensions_tpu_torch.ops import igso3_cuda
from conftest import require_golden

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def g():
    return require_golden("igso3.npz")


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _kernel_inputs(n, seed=0):
    """t uniform on (0, pi) with t = 0, t in (0, 1e-6), t in (1e-6, 1e-4)
    and t near pi; sigma uniform on [0.02, 1.5] with sigma = 1e-3 entries."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(0.0, np.pi, n).astype(np.float32)
    s = rng.uniform(0.02, 1.5, n).astype(np.float32)
    t[:6] = [0.0, 3e-7, 5e-6, 5e-5, np.pi - 1e-4, np.float32(np.pi)]
    s[6:9] = 1e-3
    return t, s


@pytest.mark.parametrize("n", [32, 1000, 1037])
def test_logpdf_score_ref_matches_jax_and_pallas(n):
    t, s = _kernel_inputs(n, seed=n)
    logf, score = igso3_cuda.igso3_logpdf_score_ref(_t(t), _t(s))
    ref_logf = np.asarray(jig.igso3_log_density(jnp.asarray(t), jnp.asarray(s)))
    ref_score = np.asarray(jig.igso3_score_angle(jnp.asarray(t), jnp.asarray(s)))
    np.testing.assert_allclose(logf, ref_logf, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(score, ref_score, rtol=1e-4, atol=5e-4)
    p_logf, p_score = igso3_logpdf_score_pallas(
        jnp.asarray(t), jnp.asarray(s), interpret=True
    )
    np.testing.assert_allclose(logf, np.asarray(p_logf), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(score, np.asarray(p_score), rtol=1e-4, atol=5e-4)


def test_wrapper_broadcasts_and_stays_plain_on_cpu():
    before = obs.counter("ops.igso3.launches")
    t = torch.linspace(0.1, 3.0, 7).reshape(7, 1)
    logf, score = igso3_cuda.igso3_logpdf_score(t, torch.tensor([0.5]))
    assert logf.shape == (7, 1) and score.shape == (7, 1)
    p_logf, p_score = igso3_logpdf_score_pallas(
        jnp.asarray(t.numpy()), jnp.asarray([0.5]), interpret=True
    )
    np.testing.assert_allclose(logf, np.asarray(p_logf), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(score, np.asarray(p_score), rtol=1e-4, atol=5e-4)
    # the plain path neither builds nor launches the kernel
    assert obs.counter("ops.igso3.launches") == before == 0
    assert igso3_cuda._fn is None


def test_wrapper_refuses_mixed_devices():
    with pytest.raises(ValueError):
        igso3_cuda.igso3_logpdf_score(torch.zeros(3), torch.zeros(3, device="meta"))


def test_module_imports_without_nvcc_or_triton():
    """Importing the module builds nothing and needs neither nvcc nor triton."""
    code = (
        "import sys, importlib.abc\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] == 'triton':\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import os; os.environ['PATH'] = '/nonexistent'\n"
        "from diffusion_extensions_tpu_torch import obs\n"
        "from diffusion_extensions_tpu_torch.ops import igso3_cuda, igso3\n"
        "assert igso3_cuda._fn is None and obs.counter('ops.igso3.launches') == 0\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_series_np_and_log_density_golden(g):
    t, eps = g["t"], g["eps"]
    ours = tig.igso3_series_np(t[None, :].astype(np.float64), eps[:, None].astype(np.float64))
    np.testing.assert_allclose(ours, g["dens"], rtol=1e-6, atol=1e-7)
    log_ours = tig.igso3_log_density(_t(t)[None, :], _t(eps)[:, None]).numpy()
    mask = g["dens"] > 0
    log_ref = np.log(g["dens"][mask])
    sane = np.abs(log_ref) < 30
    assert np.abs(log_ours[mask] - log_ref)[sane].max() < 1e-5


def test_log_prob_golden_and_parity(g):
    d = tig.IsotropicGaussianSO3.create(0.5, device="cpu")
    lp = d.log_prob(_t(g["rots"])).numpy()
    ref = g["log_prob_eps05"].squeeze(-1)
    ok = np.isfinite(ref)
    assert np.abs(lp[ok] - ref[ok]).max() < 1e-4
    jd = jig.IsotropicGaussianSO3.create(jnp.float32(0.5))
    np.testing.assert_allclose(lp, np.asarray(jd.log_prob(jnp.asarray(g["rots"]))),
                               rtol=1e-5, atol=1e-5)


def test_score_vec_matches_jax():
    rng = np.random.default_rng(3)
    v = rng.standard_normal((64, 3)).astype(np.float32)
    r = np.asarray(jso3.exp_skewvec(jnp.asarray(v)))
    sigma = rng.uniform(0.05, 1.2, 64).astype(np.float32)
    ours = tig.igso3_score_vec(_t(r), _t(sigma)).numpy()
    ref = np.asarray(jig.igso3_score_vec(jnp.asarray(r), jnp.asarray(sigma)))
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=5e-4)


def test_cdf_tables_equal_jax(g):
    """Host-built tables are numpy on both sides: equal arrays."""
    locs, cdf = tig.build_cdf_np(g["eps_tab"])
    np.testing.assert_allclose(cdf, g["trap"].T, atol=2e-6)
    np.testing.assert_allclose(locs, g["trap_loc"], atol=1e-6)
    from diffusion_extensions_tpu.processes.so3 import SO3Diffusion as JSO3

    jproc = JSO3.create(50)
    eps = np.asarray(jproc.q_table.eps)
    tt = tig.IGSO3Table.from_eps(eps, device="cpu")
    np.testing.assert_array_equal(tt.cdf.numpy(), np.asarray(jproc.q_table.cdf))
    np.testing.assert_array_equal(tt.inv_cdf.numpy(), np.asarray(jproc.q_table.inv_cdf))
    np.testing.assert_array_equal(tt.trap_locs.numpy(), np.asarray(jproc.q_table.trap_locs))


def test_build_cdf_torch_matches_jax():
    eps = np.array([0.05, 0.3, 1.0], dtype=np.float32)
    locs_t, cdf_t = tig.build_cdf(_t(eps))
    locs_j, cdf_j = jig.build_cdf(jnp.asarray(eps))
    np.testing.assert_allclose(locs_t, np.asarray(locs_j), atol=0)
    np.testing.assert_allclose(cdf_t, np.asarray(cdf_j), atol=5e-6)


@pytest.fixture(scope="module")
def tables():
    eps = np.concatenate([[1e-10, 1e-3], np.linspace(0.01, 1.5, 14)]).astype(np.float32)
    return tig.IGSO3Table.from_eps(eps, device="cpu"), jig.IGSO3Table.from_eps(eps)


def test_quantile_cdf_transport_with_explicit_inputs(tables):
    """Explicit u and theta: pow(1/3) replaces cbrt in the knot inversion and
    the grid index, so positions differ by an ulp; the lerp then moves an
    angle by at most slope * ulp (1e-5 rad at the steep tails)."""
    tt, jt = tables
    rng = np.random.default_rng(5)
    n = 4096
    u = rng.uniform(0.0, 1.0, n).astype(np.float32)
    u[:4] = [0.0, 1e-7, 1.0 - 1e-7, 1.0]
    idx = rng.integers(0, len(np.asarray(jt.eps)), n)
    theta = rng.uniform(0.0, np.pi, n).astype(np.float32)
    theta[:3] = [0.0, 1e-6, np.pi]
    idx2 = rng.integers(0, len(np.asarray(jt.eps)), n)
    ti, ji = torch.from_numpy(idx), jnp.asarray(idx, jnp.int32)
    ti2, ji2 = torch.from_numpy(idx2), jnp.asarray(idx2, jnp.int32)
    np.testing.assert_allclose(
        tt.quantile_angles(_t(u), ti), np.asarray(jt.quantile_angles(jnp.asarray(u), ji)),
        atol=1e-5,
    )
    np.testing.assert_allclose(
        tt.cdf_angles(_t(theta), ti), np.asarray(jt.cdf_angles(jnp.asarray(theta), ji)),
        atol=1e-5,
    )
    np.testing.assert_allclose(
        tt.transport_angles(_t(theta), ti, ti2),
        np.asarray(jt.transport_angles(jnp.asarray(theta), ji, ji2)),
        atol=1e-4,
    )


def test_table_sampling_distribution(tables):
    """The port's own draws follow the table's CDF (different RNG stream
    from JAX, so the check is distributional)."""
    tt, _ = tables
    gen = torch.Generator().manual_seed(0)
    row = 10
    angles = tt.sample_angles(gen, torch.full((20000,), row)).numpy()
    cdf, locs = tt.cdf[row].numpy(), tt.trap_locs.numpy()
    for q in (0.1, 0.25, 0.5, 0.75, 0.9):
        assert abs((angles <= np.interp(q, cdf, locs)).mean() - q) < 0.02
    rots = tt.sample(gen, torch.full((256,), row))
    assert rots.shape == (256, 3, 3)
    np.testing.assert_allclose(
        rots @ rots.transpose(-1, -2), np.broadcast_to(np.eye(3), rots.shape), atol=1e-5
    )
    # the degenerate 1e-10 row is a delta at ~0
    assert float(tt.sample_angles(gen, torch.zeros(512, dtype=torch.long)).max()) < 1e-6


def test_isotropic_sample_matches_reference_distribution(g):
    from scipy.stats import ks_2samp

    d = tig.IsotropicGaussianSO3.create(0.5, device="cpu")
    ours = tig.rotation_angle(d.sample(torch.Generator().manual_seed(42), (20000,))).numpy()
    assert ks_2samp(g["sampled_angles_eps05"], ours).pvalue > 0.01


# ---------------------------------------------------------------------------
# What the kernel's wrapper does in Python, and the kernel's arithmetic
# ---------------------------------------------------------------------------

def _operand_cases():
    t7 = torch.linspace(0.1, 3.0, 7).reshape(7, 1)
    t, s = (_t(a) for a in _kernel_inputs(40, seed=4))
    return {
        "0-dim sigma": (t, torch.tensor(0.5), (1, 0), (True, True)),
        "1-element sigma": (t, torch.tensor([0.5]), (1, 0), (True, True)),
        "(7,1)x(1,)": (t7, torch.tensor([0.5]), (1, 0), (True, True)),
        "same shape": (t, s, (1, 1), (True, True)),
        "one t, many sigma": (torch.tensor(0.7), s, (0, 1), (True, True)),
        "(7,1)x(5,)": (t7, s[:5].clamp(min=0.05), (1, 1), (False, False)),
        "strided t": (t[::2], s[:20], (1, 1), (False, True)),
        "both one value": (torch.tensor([0.7]), torch.tensor(0.5), (0, 0), (True, True)),
    }


@pytest.mark.parametrize("case", list(_operand_cases()))
def test_plan_operands_strides_and_no_copy(case):
    """plan_operands + the C entry's indexing t[i * t_stride],
    sigma[i * sigma_stride] give the broadcast call's values (equal bits on
    the plain version, and the Pallas kernel's within its gates); operands
    the strides can express are passed in place."""
    t, sigma, strides, in_place = _operand_cases()[case]
    shape, t_arg, t_stride, s_arg, s_stride = igso3_cuda.plan_operands(t, sigma)
    assert shape == torch.broadcast_shapes(t.shape, sigma.shape)
    assert (t_stride, s_stride) == strides
    assert (t_arg.data_ptr() == t.data_ptr(), s_arg.data_ptr() == sigma.data_ptr()) == in_place
    assert (t_arg is t, s_arg is sigma) == in_place
    assert t_arg.is_contiguous() and s_arg.is_contiguous()
    t_flat, s_flat = t_arg.reshape(-1), s_arg.reshape(-1)
    n = int(np.prod(shape))
    assert t_flat.numel() == (n if t_stride else 1) and s_flat.numel() == (n if s_stride else 1)
    i = torch.arange(n)
    logf, score = igso3_cuda.igso3_logpdf_score_ref(t_flat[i * t_stride], s_flat[i * s_stride])
    want_logf, want_score = igso3_cuda.igso3_logpdf_score_ref(t, sigma)
    assert torch.equal(logf.view(shape), want_logf) and torch.equal(score.view(shape), want_score)
    bt, bs = np.broadcast_arrays(t.numpy(), sigma.numpy())
    p_logf, p_score = igso3_logpdf_score_pallas(jnp.asarray(bt), jnp.asarray(bs), interpret=True)
    np.testing.assert_allclose(logf.view(shape), np.asarray(p_logf), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(score.view(shape), np.asarray(p_score), rtol=1e-4, atol=5e-4)


@pytest.mark.parametrize("shape", [(32,), (7, 1), (3, 5, 7), (4, 8), (50_000,), (0,), ()])
def test_alloc_outputs_is_one_allocation(shape):
    logf, score = igso3_cuda.alloc_outputs(shape, "cpu")
    n = int(np.prod(shape))
    assert logf.shape == shape and score.shape == shape
    assert logf.dtype == score.dtype == torch.float32
    assert logf.untyped_storage().data_ptr() == score.untyped_storage().data_ptr()
    assert logf.untyped_storage().nbytes() == 8 * n
    if n:
        assert logf.is_contiguous() and score.is_contiguous()
        assert score.data_ptr() - logf.data_ptr() == 4 * n
        logf.fill_(1.0)
        score.fill_(2.0)
        assert float(logf.sum()) == n and float(score.sum()) == 2 * n


def _band(sigma):
    """Angles dense over the cancellation band and the path switch, the
    whole of [1e-7, pi] and the approach to pi, with t = 0 and pi."""
    t = np.concatenate([np.geomspace(1e-4, 5e-2, 4096), np.geomspace(1e-7, np.pi, 4096),
                        np.pi - np.geomspace(1e-7, 0.3, 4096), [0.0, np.pi]])
    t = np.minimum(t.astype(np.float32), np.float32(np.pi))
    return t, np.full_like(t, sigma)


@pytest.mark.parametrize("sigma", [1e-3, 0.02, 0.05, 0.4, 1.0, 1.5])
def test_kernel_math_ref_matches_jax_and_plain(sigma):
    """The kernel's arithmetic (cheap path on its domain, the plain
    expression elsewhere) in plain float32 PyTorch, against the JAX
    functions and the port's plain version: the kernel's gates."""
    t, s = _band(sigma)
    logf, score = igso3_cuda.kernel_math_ref(_t(t), _t(s))
    assert torch.isfinite(logf).all() and torch.isfinite(score).all()
    cheap = igso3_cuda.cheap_domain(_t(t), _t(s))
    assert cheap.any() and not cheap.all()
    ref_logf, ref_score = igso3_cuda.igso3_logpdf_score_ref(_t(t), _t(s))
    np.testing.assert_allclose(logf, ref_logf, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(score, ref_score, rtol=1e-4, atol=5e-4)
    # against JAX where the kernel's arithmetic is its own (elsewhere it is
    # the plain version's, which the tests above hold against JAX)
    j_logf = np.asarray(jig.igso3_log_density(jnp.asarray(t), jnp.asarray(s)))
    j_score = np.asarray(jig.igso3_score_angle(jnp.asarray(t), jnp.asarray(s)))
    np.testing.assert_allclose(logf[cheap], j_logf[cheap], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(score[cheap], j_score[cheap], rtol=1e-4, atol=5e-4)


def test_cheap_domain_boundaries():
    lo = np.float32(igso3_cuda.EXACT_BELOW)
    t = _t([np.nextafter(lo, np.float32(0)), lo, 1.0, 3.1415927, 3.2, 0.0, float("nan")])
    np.testing.assert_array_equal(igso3_cuda.cheap_domain(t, torch.tensor(0.5)),
                                  [False, True, True, True, False, False, False])
    # near pi with a small sigma, and sigma outside the cheap path's range
    near = _t([3.1415927, 3.14, 3.0])
    np.testing.assert_array_equal(igso3_cuda.cheap_domain(near, torch.tensor(0.02)),
                                  [False, False, True])
    np.testing.assert_array_equal(
        igso3_cuda.cheap_domain(torch.tensor(1.0), _t([1e-6, 1e-3, 1e11, float("nan")])),
        [False, True, False, False])


def test_kernel_source_holds_the_python_constants():
    """The constants of csrc/igso3_logpdf_score.cu are those of the Python
    mirror that the CPU tests exercise."""
    import re

    src = igso3_cuda.SOURCE.read_text()
    consts = {k: float(v) for k, v in re.findall(r"constexpr float (k\w+) = ([-+.\deE]+)f;", src)}
    for prefix, poly in (("kSin", igso3_cuda.SIN_POLY), ("kCos", igso3_cuda.COS_POLY),
                         ("kSinh", igso3_cuda.SINH_POLY), ("kCosh", igso3_cuda.COSH_POLY)):
        got = [1.0] + [consts[f"{prefix}{i}"] for i in range(1, len(poly))]
        assert got == list(poly), prefix
        assert f"{prefix}{len(poly)}" not in consts
    assert consts["kExactBelow"] == igso3_cuda.EXACT_BELOW
    assert consts["kCheapMaxT"] == igso3_cuda.CHEAP_MAX_T
    assert (consts["kCheapMinVar"], consts["kCheapMaxVar"]) == (
        igso3_cuda.CHEAP_MIN_VAR, igso3_cuda.CHEAP_MAX_VAR)
    assert (consts["kNearPiMinU"], consts["kNearPiGap"]) == (
        igso3_cuda.NEAR_PI_MIN_U, igso3_cuda.NEAR_PI_GAP)


def test_kernel_wrapper_defines_no_gradient():
    """``igso3_logpdf_score`` raises on an input that requires grad (on the
    CPU before it takes the plain path, on the card before it launches),
    instead of returning tensors cut from the graph; under ``no_grad`` and
    on detached tensors it runs, and the plain version differentiates."""
    from diffusion_extensions_tpu_torch.ops import igso3_cuda

    t = torch.linspace(0.1, 3.0, 8).requires_grad_(True)
    sigma = torch.full((8,), 0.5)
    with pytest.raises(RuntimeError, match="defines no gradient"):
        igso3_cuda.igso3_logpdf_score(t, sigma)
    with pytest.raises(RuntimeError, match="defines no gradient"):
        igso3_cuda.igso3_logpdf_score(t.detach(), sigma.clone().requires_grad_(True))
    with torch.no_grad():
        logf, score = igso3_cuda.igso3_logpdf_score(t, sigma)
    ref_logf, ref_score = igso3_cuda.igso3_logpdf_score(t.detach(), sigma)
    assert torch.equal(logf, ref_logf) and torch.equal(score, ref_score)
    out, _ = igso3_cuda.igso3_logpdf_score_ref(t, sigma)
    out.sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), ref_score.numpy(), rtol=1e-3, atol=1e-4)
