"""Tests of the port's CUDA kernels; they need an NVIDIA GPU and skip without one.

On a machine with a card (and without JAX), run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

This file imports torch and the port only.
"""
import numpy as np
import pytest
import torch

from diffusion_extensions_tpu_torch.ops import igso3_cuda, metrics, mmd_cuda
from diffusion_extensions_tpu_torch.ops.so3 import exp_skewvec

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(n, seed, device):
    rng = np.random.default_rng(seed)
    t = rng.uniform(0.0, np.pi, n).astype(np.float32)
    s = rng.uniform(0.02, 1.5, n).astype(np.float32)
    t[:6] = [0.0, 3e-7, 5e-6, 5e-5, np.pi - 1e-4, np.pi]
    s[6:9] = 1e-3
    return torch.from_numpy(t).to(device), torch.from_numpy(s).to(device)


@pytest.mark.parametrize("n", [32, 1000, 2**20 + 37])
def test_kernel_matches_plain_version(cuda, n):
    """Gates of tests/test_pallas.py: log f rtol/atol 1e-5; score rtol 1e-4,
    atol 5e-4."""
    t, s = _inputs(n, n, cuda)
    before = igso3_cuda.launches
    logf, score = igso3_cuda.igso3_logpdf_score(t, s)
    torch.cuda.synchronize()
    assert igso3_cuda.launches == before + 1
    ref_logf, ref_score = igso3_cuda.igso3_logpdf_score_ref(t, s)
    torch.testing.assert_close(logf, ref_logf, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(score, ref_score, rtol=1e-4, atol=5e-4)
    # and against the plain version on the CPU
    c_logf, c_score = igso3_cuda.igso3_logpdf_score_ref(t.cpu(), s.cpu())
    torch.testing.assert_close(logf.cpu(), c_logf, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(score.cpu(), c_score, rtol=1e-4, atol=5e-4)


def test_kernel_broadcasts(cuda):
    t = torch.linspace(0.1, 3.0, 7, device=cuda).reshape(7, 1)
    logf, score = igso3_cuda.igso3_logpdf_score(t, torch.tensor([0.5], device=cuda))
    assert logf.shape == (7, 1) and score.shape == (7, 1)
    ref_logf, _ = igso3_cuda.igso3_logpdf_score_ref(t.cpu(), torch.tensor([0.5]))
    torch.testing.assert_close(logf.cpu(), ref_logf, rtol=1e-5, atol=1e-5)


def test_kernel_refuses_other_dtypes(cuda):
    with pytest.raises(TypeError):
        igso3_cuda.igso3_logpdf_score(torch.zeros(4, device=cuda, dtype=torch.float64),
                                      torch.ones(4, device=cuda, dtype=torch.float64))


def test_heun_sampler_launches_kernel_twice_per_step(cuda):
    from diffusion_extensions_tpu_torch.models.planenet import PlaneNet
    from diffusion_extensions_tpu_torch.models.projections import PointCloudProj
    from diffusion_extensions_tpu_torch.processes.so3 import ProjectedSO3Diffusion

    torch.manual_seed(0)
    model = PlaneNet(dim=64, heads=4, layers=1).to(cuda).eval()
    proc = ProjectedSO3Diffusion(50, device=cuda)
    proj = PointCloudProj(torch.randn(4, 32, 3, device=cuda))
    before = igso3_cuda.launches
    with torch.inference_mode():
        out = proc.pf_sample_loop(model, None, (4,), 7, proj, method="heun")
    assert igso3_cuda.launches == before + 14
    assert torch.isfinite(out).all()


def _rots(n, seed, device, scale=1.0):
    v = np.random.default_rng(seed).standard_normal((n, 3)).astype(np.float32) * scale
    return exp_skewvec(torch.from_numpy(v)).to(device)


@pytest.mark.parametrize("n,m", [(1, 1), (257, 130), (300, 200), (4096, 1000)])
def test_mmd_kernel_matches_plain_version(cuda, n, m):
    """Gate of tests/test_pallas.py: rtol 1e-4 on the sum, on the card and
    against the plain version on the CPU; 257 x 130 is the masking case."""
    x, y = _rots(n, n, cuda), _rots(m, m + 1, cuda, 0.3)
    before = mmd_cuda.launches
    got = mmd_cuda.gaussian_kernel_sum(x, y)
    torch.cuda.synchronize()
    assert mmd_cuda.launches == before + 1
    assert got.shape == () and got.device == x.device
    torch.testing.assert_close(got, mmd_cuda.gaussian_kernel_sum_ref(x, y), rtol=1e-4, atol=0)
    ref_cpu = mmd_cuda.gaussian_kernel_sum_ref(x.cpu(), y.cpu())
    torch.testing.assert_close(got.cpu(), ref_cpu, rtol=1e-4, atol=0)


def test_mmd_kernel_identity_and_pi_pairs(cuda):
    """X = Y (theta = 0 on the diagonal) and exact-pi relative rotations."""
    x = _rots(2000, 5, cuda)
    torch.testing.assert_close(mmd_cuda.gaussian_kernel_sum(x, x),
                               mmd_cuda.gaussian_kernel_sum_ref(x, x), rtol=1e-4, atol=0)
    u = torch.nn.functional.normalize(torch.randn(500, 3, dtype=torch.float64), dim=-1)
    pi = (2.0 * u[:, :, None] * u[:, None, :] - torch.eye(3, dtype=torch.float64))
    y = (x[:500].double() @ pi.to(cuda)).float()
    got = mmd_cuda.gaussian_kernel_sum(x[:500], y)
    torch.testing.assert_close(got, mmd_cuda.gaussian_kernel_sum_ref(x[:500], y), rtol=1e-4,
                               atol=0)


def test_mmd_kernel_is_deterministic(cuda):
    x, y = _rots(20_000, 7, cuda), _rots(20_000, 8, cuda, 0.5)
    a = mmd_cuda.gaussian_kernel_sum(x, y)
    b = mmd_cuda.gaussian_kernel_sum(x, y)
    assert torch.equal(a, b)


def test_mmd_on_the_card_goes_through_the_kernel(cuda):
    """metrics.mmd with the Gaussian kernel: 3 launches whatever chunksize
    says; rtol 1e-3 / atol 1e-5 against the plain MMD on the CPU."""
    x, y = _rots(3000, 9, cuda), _rots(2500, 10, cuda, 0.4)
    before = mmd_cuda.launches
    got = metrics.mmd(x, y, metrics.gaussian_kernel_matrix, chunksize=1000)
    assert mmd_cuda.launches == before + 3
    want = metrics.mmd(x.cpu(), y.cpu(), metrics.gaussian_kernel_matrix, chunksize=1000)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-5)
    torch.testing.assert_close(mmd_cuda.mmd_cuda(x, y).cpu(), want, rtol=1e-3, atol=1e-5)


def test_mmd_kernel_refuses_bad_inputs(cuda):
    x = _rots(4, 11, cuda)
    with pytest.raises(TypeError):
        mmd_cuda.gaussian_kernel_sum(x.double(), x.double())
    with pytest.raises(ValueError):
        mmd_cuda.gaussian_kernel_sum(x, x.cpu())
    with pytest.raises(ValueError):
        mmd_cuda.gaussian_kernel_sum(x[:0], x)
    with pytest.raises(ValueError):
        mmd_cuda.gaussian_kernel_sum(x.reshape(4, 9), x)
