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


def _hold_to_plain(logf, score, t, s):
    """The gates (log f rtol/atol 1e-5; score rtol 1e-4, atol 5e-4) against
    the plain version on the card, which rounds as the kernel's exact path
    does, and on the CPU.  Against the CPU's math library the score's atol
    is max(5e-4, 2 ulp(1/t)) for t >= 1e-4: there the score is a difference
    of two terms of size 1/t, each rounded on its own, so two correct
    evaluations may differ by an ulp of 1/t in each.  That is 5e-4 from
    t = 4.9e-4 up and at most 1.95e-3 (at t = 1e-4)."""
    ref_logf, ref_score = igso3_cuda.igso3_logpdf_score_ref(t, s)
    torch.testing.assert_close(logf, ref_logf, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(score, ref_score, rtol=1e-4, atol=5e-4)
    t, s = t.cpu(), s.cpu()
    ref_logf, ref_score = igso3_cuda.igso3_logpdf_score_ref(t, s)
    torch.testing.assert_close(logf.cpu(), ref_logf, rtol=1e-5, atol=1e-5)
    inv = 1.0 / t.clamp(min=1e-4)
    ulp = torch.nextafter(inv, torch.full_like(inv, float("inf"))) - inv
    atol = torch.where(t >= 1e-4, (2.0 * ulp).clamp(min=5e-4), torch.full_like(inv, 5e-4))
    excess = (score.cpu() - ref_score).abs() - (atol + 1e-4 * ref_score.abs())
    assert float(excess.max()) <= 0.0, f"score off by {float(excess.max())} beyond its gate"


@pytest.mark.parametrize("sigma_shape", [(), (1,)])
def test_kernel_reads_a_one_value_sigma_in_place(cuda, sigma_shape):
    """The log_prob shape: 50,000 angles, one sigma.  sigma is passed as it
    is (stride 0, no expanded copy) and the results are those of the
    expanded call, bit for bit."""
    t, _ = _inputs(50_000, 3, cuda)
    sigma = torch.full(sigma_shape, 0.5, device=cuda)
    _, t_arg, t_stride, sigma_arg, sigma_stride = igso3_cuda.plan_operands(t, sigma)
    assert (t_stride, sigma_stride) == (1, 0)
    assert t_arg is t and sigma_arg is sigma
    before = igso3_cuda.launches
    logf, score = igso3_cuda.igso3_logpdf_score(t, sigma)
    assert igso3_cuda.launches == before + 1
    assert logf.shape == t.shape and score.shape == t.shape
    full_logf, full_score = igso3_cuda.igso3_logpdf_score(t, sigma.expand(t.shape).contiguous())
    assert torch.equal(logf, full_logf) and torch.equal(score, full_score)
    _hold_to_plain(logf, score, t, sigma)


def test_kernel_strides_change_no_result(cuda):
    """(7,1) x (1,), one t against many sigma, a t that starts off a 16-byte
    boundary and a broadcast the strides cannot express: each equals the
    dense call on the expanded operands, bit for bit."""
    t7 = torch.linspace(0.1, 3.0, 7, device=cuda).reshape(7, 1)
    t, s = _inputs(1001, 5, cuda)
    cases = [(t7, torch.tensor([0.5], device=cuda)), (torch.tensor(0.7, device=cuda), s),
             (t[1:], s[1:]), (t7, s[:5].clamp(min=0.05))]
    for a, b in cases:
        logf, score = igso3_cuda.igso3_logpdf_score(a, b)
        ea, eb = (v.contiguous() for v in torch.broadcast_tensors(a, b))
        full_logf, full_score = igso3_cuda.igso3_logpdf_score(ea.clone(), eb.clone())
        assert logf.shape == ea.shape
        assert torch.equal(logf, full_logf) and torch.equal(score, full_score)
        _hold_to_plain(logf, score, ea, eb)


@pytest.mark.parametrize("sigma", [0.05, 0.4, 1.0, 1.5])
def test_kernel_holds_the_cancellation_band(cuda, sigma):
    """4096 angles log-spaced over [1e-4, 5e-2]: the band where the score
    is a difference of two ~1/t terms, and the switch between the kernel's
    two arithmetic paths at t = 0.02."""
    t = torch.from_numpy(np.geomspace(1e-4, 5e-2, 4096).astype(np.float32)).to(cuda)
    s = torch.tensor(sigma, device=cuda)
    logf, score = igso3_cuda.igso3_logpdf_score(t, s)
    _hold_to_plain(logf, score, t, s)


def test_kernel_is_the_plain_version_to_the_bit_on_its_exact_path(cuda):
    """Below t = EXACT_BELOW, and near t = pi with a small sigma, the kernel
    evaluates the plain version's expression operation by operation: equal
    bits on the card (below t = 1e-4 the score's limit within its gate only:
    there PyTorch divides t by 12 as a product with 1/12 on the card, an ulp
    of ~1e-5 away).  Just above the threshold the gates hold."""
    lo = np.float32(igso3_cuda.EXACT_BELOW)
    below = np.nextafter(lo, np.float32(0))
    rng = np.random.default_rng(11)
    t = np.concatenate([rng.uniform(0.0, below, 4096), [0.0, 1e-7, 1e-5, 1e-4, below]])
    s = rng.uniform(0.02, 1.5, t.size)
    t_pi = np.pi - rng.uniform(0.0, 15.0, 2048) * 0.02**2 / np.pi  # u (pi - t) < 15
    t = torch.from_numpy(np.concatenate([t, t_pi]).astype(np.float32)).to(cuda)
    s = torch.from_numpy(np.concatenate([s, np.full(2048, 0.02)]).astype(np.float32)).to(cuda)
    assert not igso3_cuda.cheap_domain(t, s).any()
    logf, score = igso3_cuda.igso3_logpdf_score(t, s)
    ref_logf, ref_score = igso3_cuda.igso3_logpdf_score_ref(t, s)
    direct = t >= 1e-4
    assert torch.equal(logf, ref_logf) and torch.equal(score[direct], ref_score[direct])
    torch.testing.assert_close(score, ref_score, rtol=1e-4, atol=5e-4)
    above = torch.tensor([lo, np.nextafter(lo, np.float32(1))], device=cuda).repeat(4)
    sig = torch.tensor([0.05, 0.4, 1.0, 1.5], device=cuda).repeat_interleave(2)
    assert igso3_cuda.cheap_domain(above, sig).all()
    _hold_to_plain(*igso3_cuda.igso3_logpdf_score(above, sig), above, sig)


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


def test_mmd_kernel_theta_sweep(cuda):
    """One X against 4096 rotations X exp(theta_m axis), theta dense on
    [0, pi] with both ends: every octant of the kernel's atan2 and both of
    its selects.  rtol 1e-5 against the plain sum and against
    sum exp(-sqrt(2) theta_m) in float64."""
    theta = np.linspace(0.0, np.pi, 4096)
    axis = np.array([0.3, -0.5, 0.81])
    axis /= np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    rel = (np.eye(3) + np.sin(theta)[:, None, None] * k
           + (1 - np.cos(theta))[:, None, None] * (k @ k))
    x64 = _rots(1, 21, "cpu").double().numpy()
    x = torch.from_numpy(x64.astype(np.float32)).to(cuda)
    y = torch.from_numpy((x64 @ rel).astype(np.float32)).to(cuda)
    got = mmd_cuda.gaussian_kernel_sum(x, y)
    torch.testing.assert_close(got, mmd_cuda.gaussian_kernel_sum_ref(x, y), rtol=1e-5, atol=0)
    np.testing.assert_allclose(float(got), np.exp(-np.sqrt(2.0) * theta).sum(), rtol=1e-5)
    # the same pairs one at a time (N = M = 1 launches) at both ends and mid-way
    for i in (0, 1, 2047, 4094, 4095):
        one = mmd_cuda.gaussian_kernel_sum(x, y[i:i + 1])
        np.testing.assert_allclose(float(one), np.exp(-np.sqrt(2.0) * theta[i]), rtol=2e-6,
                                   atol=2e-7)


@pytest.mark.parametrize("case", ["under one tile", "one column", "tile plus one",
                                  "one row", "two tiles less one"])
def test_mmd_kernel_ragged_tiles(cuda, case):
    """Sizes that leave a ragged tile in each direction of the built tile
    shape (several X rows a thread): rows past N or M add nothing."""
    tile_n, tile_m = mmd_cuda.tile_shape()
    n, m = {"under one tile": (tile_n - 3, tile_m - 1), "one column": (tile_n + 5, 1),
            "tile plus one": (tile_n + 1, tile_m + 1), "one row": (1, tile_m + 1),
            "two tiles less one": (2 * tile_n - 1, 2 * tile_m - 1)}[case]
    x, y = _rots(n, n, cuda), _rots(m, m + 1, cuda, 0.3)
    got = mmd_cuda.gaussian_kernel_sum(x, y)
    torch.testing.assert_close(got, mmd_cuda.gaussian_kernel_sum_ref(x, y), rtol=1e-4, atol=0)
    torch.testing.assert_close(got.cpu(), mmd_cuda.gaussian_kernel_sum_ref(x.cpu(), y.cpu()),
                               rtol=1e-4, atol=0)


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


def test_captured_train_steps_give_the_bits_of_eager_steps(cuda):
    """``steps_per_call=4`` on the card replays one CUDA graph a sub-step:
    12 steps in three calls give the weights of 12 eager steps to the bit,
    from the same init, batches and generator seed, and the generator state
    they leave behind continues an eager run to the bit."""
    from diffusion_extensions_tpu_torch.models.rot_predict import RotPredict
    from diffusion_extensions_tpu_torch.parallel.dp import make_dp_train_step
    from diffusion_extensions_tpu_torch.processes.so3 import SO3Diffusion
    from diffusion_extensions_tpu_torch.train.optim import make_optimizer
    from diffusion_extensions_tpu_torch.train.state import TrainState

    proc = SO3Diffusion.create(100, device=cuda)
    batches = torch.stack([_rots(64, 40 + i, cuda) for i in range(16)])

    def fresh(k):
        torch.manual_seed(0)
        model = RotPredict(65, "skewvec").to(cuda)
        opt = make_optimizer(model.named_parameters(), 1e-3, clip=1.0)
        step = make_dp_train_step(lambda g, x: proc.loss(model, g, x), model, opt,
                                  steps_per_call=k, log_norms=True)
        return TrainState(model, opt, torch.Generator(device=cuda).manual_seed(3)), step

    eager, step1 = fresh(1)
    for x in batches:
        eager, m1 = step1(eager, x)
        if eager.step == 12:
            at_12 = [p.detach().clone() for p in eager.model.parameters()]
            m1_12 = {k: float(v) for k, v in m1.items()}
    graphed, step4 = fresh(4)
    for i in range(0, 12, 4):
        graphed, m4 = step4(graphed, batches[i : i + 4])
    torch.cuda.synchronize()
    assert graphed.step == 12
    for p, q in zip(graphed.model.parameters(), at_12):
        assert torch.equal(p, q)
    assert {k: float(v) for k, v in m4.items()} == m1_12
    # the last four steps eagerly from the graphed state: the generator is where it should be
    model = graphed.model
    tail = make_dp_train_step(lambda g, x: proc.loss(model, g, x), model, graphed.optimizer)
    for x in batches[12:]:
        graphed, _ = tail(graphed, x)
    for p, q in zip(graphed.model.parameters(), eager.model.parameters()):
        assert torch.equal(p, q)


def _protein_setup(cuda, bf16=False, k=1, seed=0):
    """A small ProtNet (dim 64, all flags) on 4 synthetic pairs, the
    protein driver's loss and a step with ``steps_per_call=k``."""
    from diffusion_extensions_tpu_torch.experiments import protein
    from diffusion_extensions_tpu_torch.models.protnet import ProtNet
    from diffusion_extensions_tpu_torch.parallel.dp import make_dp_train_step
    from diffusion_extensions_tpu_torch.processes.se3 import ProjectedSE3Diffusion
    from diffusion_extensions_tpu_torch.train.optim import make_optimizer
    from diffusion_extensions_tpu_torch.train.state import TrainState

    torch.manual_seed(seed)
    model = ProtNet(dim=64, heads=4, t_depth=2, c_depth=3, frame_pool=True, cross_depth=1,
                    rel_frame=True, equiv_head=True, bf16=bf16).to(cuda)
    proc = ProjectedSE3Diffusion(100, clip_shift=75.0, device=cuda)
    opt = make_optimizer(model.named_parameters(), 1e-3, impl="fused")
    step = make_dp_train_step(protein.make_loss_fn(model, proc), model, opt, steps_per_call=k,
                              log_norms=True)
    return TrainState(model, opt, torch.Generator(device=cuda).manual_seed(3)), step, proc


def _protein_batches(n):
    from types import SimpleNamespace

    from diffusion_extensions_tpu_torch.experiments import protein

    args = protein.parse_args(["--se3", "--batch", "4"])
    pairs = protein.load_pairs(SimpleNamespace(data_root="/nonexistent"))
    rng = np.random.default_rng(0)
    out = []
    while len(out) < n:
        out += list(protein.make_batches(pairs, args, rng))
    return out[:n]


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_captured_protein_steps_give_the_bits_of_eager_steps(cuda, bf16):
    """The protein step (a nested NamedTuple batch with bool masks, the
    fused pass's block mask built on the device) replayed from a CUDA graph
    with K = 4: 8 steps in two calls give the weights and the last loss of
    8 eager steps to the bit."""
    from diffusion_extensions_tpu_torch.data.pdb import to_device
    from diffusion_extensions_tpu_torch.experiments.protein import stack_batches

    batches = _protein_batches(8)
    eager, step1, _ = _protein_setup(cuda, bf16)
    for b in batches:
        eager, m1 = step1(eager, to_device(b, cuda))
    graphed, step4, _ = _protein_setup(cuda, bf16, k=4)
    for i in (0, 4):
        graphed, m4 = step4(graphed, to_device(stack_batches(batches[i : i + 4]), cuda))
    torch.cuda.synchronize()
    assert graphed.step == eager.step == 8
    assert float(m4["loss"]) == float(m1["loss"])
    for p, q in zip(graphed.model.parameters(), eager.model.parameters()):
        assert torch.equal(p, q)


def test_protein_heun_sampler_launches_kernel_twice_per_step(cuda):
    """The SE(3) Heun sampler's rotation score runs the IGSO(3) kernel once
    per model evaluation: 2 launches a step, none in the final estimate."""
    from diffusion_extensions_tpu_torch.data.pdb import to_device
    from diffusion_extensions_tpu_torch.models.projections import ProtProjection

    state, _, proc = _protein_setup(cuda)
    proj = ProtProjection(to_device(_protein_batches(1)[0], cuda))
    before = igso3_cuda.launches
    with torch.inference_mode():
        out = proc.pf_sample_loop(state.model.eval(), torch.Generator(device=cuda).manual_seed(0),
                                  (4,), 6, proj, method="heun")
    assert igso3_cuda.launches == before + 12
    assert torch.isfinite(out.rot).all() and torch.isfinite(out.shift).all()


def test_to_device_packs_one_pinned_copy(cuda):
    """A nested protein batch moved in one copy equals leaf-by-leaf copies."""
    from diffusion_extensions_tpu_torch.data.pdb import to_device

    b = _protein_batches(1)[0]
    dev = to_device(b, cuda)
    assert dev.receptor_mask.dtype == torch.bool and dev.ligand.angles.is_cuda
    for got, want in ((dev.receptor.positions, b.receptor.positions),
                      (dev.ligand.angles, b.ligand.angles), (dev.ligand_mask, b.ligand_mask)):
        assert np.array_equal(got.cpu().numpy(), want)
