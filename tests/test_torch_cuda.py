"""Tests of the port's CUDA kernels; they need an NVIDIA GPU and skip without one.

On a machine with a card (and without JAX), run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

This file imports torch and the port only.
"""
import numpy as np
import pytest
import torch

from diffusion_extensions_tpu_torch import obs
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
    before = obs.counter("ops.igso3.launches")
    logf, score = igso3_cuda.igso3_logpdf_score(t, s)
    torch.cuda.synchronize()
    assert obs.counter("ops.igso3.launches") == before + 1
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
    before = obs.counter("ops.igso3.launches")
    logf, score = igso3_cuda.igso3_logpdf_score(t, sigma)
    assert obs.counter("ops.igso3.launches") == before + 1
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
    before = obs.counter("ops.igso3.launches")
    with torch.inference_mode():
        out = proc.pf_sample_loop(model, None, (4,), 7, proj, method="heun")
    assert obs.counter("ops.igso3.launches") == before + 14
    assert torch.isfinite(out).all()


def _rots(n, seed, device, scale=1.0):
    v = np.random.default_rng(seed).standard_normal((n, 3)).astype(np.float32) * scale
    return exp_skewvec(torch.from_numpy(v)).to(device)


@pytest.mark.parametrize("n,m", [(1, 1), (257, 130), (300, 200), (4096, 1000)])
def test_mmd_kernel_matches_plain_version(cuda, n, m):
    """Gate of tests/test_pallas.py: rtol 1e-4 on the sum, on the card and
    against the plain version on the CPU; 257 x 130 is the masking case."""
    x, y = _rots(n, n, cuda), _rots(m, m + 1, cuda, 0.3)
    before = obs.counter("ops.mmd.launches")
    got = mmd_cuda.gaussian_kernel_sum(x, y)
    torch.cuda.synchronize()
    assert obs.counter("ops.mmd.launches") == before + 1
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
    before = obs.counter("ops.mmd.launches")
    got = metrics.mmd(x, y, metrics.gaussian_kernel_matrix, chunksize=1000)
    assert obs.counter("ops.mmd.launches") == before + 3
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
    before = obs.counter("ops.igso3.launches")
    with torch.inference_mode():
        out = proc.pf_sample_loop(state.model.eval(), torch.Generator(device=cuda).manual_seed(0),
                                  (4,), 6, proj, method="heun")
    assert obs.counter("ops.igso3.launches") == before + 12
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


# -- the jigsaw and diagnostics slice (the gates of chip_smoke.py's phases) --
def test_jigsaw_images_and_forward_on_the_card_match_the_cpu(cuda):
    """Every pixel of the rendered batch equal; the CoordConv forward within
    1e-4 of the output's scale."""
    from diffusion_extensions_tpu_torch.data.jigsaw import JigsawPuzzle
    from diffusion_extensions_tpu_torch.models.coordconv import CoordConv

    jp = JigsawPuzzle(seed=3)
    x = torch.randn(32, 2, generator=torch.Generator().manual_seed(0)) * 1.5
    imgs = jp(x)
    assert torch.equal(jp(x.to(cuda)).cpu(), imgs)
    torch.manual_seed(0)
    model = CoordConv().eval()
    t = torch.arange(4) * 250
    with torch.no_grad():
        ref = model(imgs[:4], t)
        got = model.to(cuda)(imgs[:4].to(cuda), t.to(cuda)).cpu()
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


def test_jigsaw_driver_resumes_to_the_bit_on_the_card(tmp_path, cuda):
    """4 steps against 2 + save + restore + 2 at batch 8 through the jigsaw driver,
    whose convolutions take cuDNN's deterministic algorithms."""
    from diffusion_extensions_tpu_torch.experiments import jigsaw

    base = ["--batch", "8", "--timesteps", "100", "--print-every", "100"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    jigsaw.main(base + ["--steps", "4", "--ckpt", a])
    jigsaw.main(base + ["--steps", "2", "--ckpt", b])
    jigsaw.main(base + ["--steps", "4", "--ckpt", b, "--resume"])
    ra, rb = (torch.load(f"{d}/step_00000004.pt", weights_only=True) for d in (a, b))
    for k, v in ra["params"].items():
        assert torch.equal(v, rb["params"][k]), k
    assert not torch.backends.cudnn.deterministic  # jigsaw.train restores the flag


def test_igso3xr3_log_prob_on_the_card_launches_kernel_1(cuda):
    """50,000 poses: one launch, log_prob inside the kernel's log f gates
    against the CPU's."""
    from diffusion_extensions_tpu_torch.ops.igso3 import IGSO3xR3
    from diffusion_extensions_tpu_torch.ops.se3 import AffineT

    gen = torch.Generator(device=cuda).manual_seed(1)
    eps = torch.rand(50_000, generator=gen, device=cuda) + 0.05
    dist = IGSO3xR3.create(eps, shift_scale=75.0, device=cuda)
    value = dist.sample(gen)
    before = obs.counter("ops.igso3.launches")
    lp = dist.log_prob(value)
    torch.cuda.synchronize()
    assert obs.counter("ops.igso3.launches") == before + 1
    cpu = IGSO3xR3.create(eps.cpu(), shift_scale=75.0, device="cpu")
    ref = cpu.log_prob(AffineT(value.rot.cpu(), value.shift.cpu()))
    torch.testing.assert_close(lp.cpu(), ref, rtol=1e-5, atol=1e-5)


def test_diagnostics_compute_on_the_card(tmp_path, cuda):
    """se3-path (14 poses, 50 steps) on SO(3) with finite shifts; grad_check
    at 800 iterations and lr 0.05 halves its loss."""
    from diffusion_extensions_tpu_torch.experiments import diagnostics, grad_check

    rots, shifts = diagnostics.main(["se3-path", "--steps", "50", "--out-dir", str(tmp_path)])
    r = torch.from_numpy(rots)
    assert rots.shape == (51, 14, 3, 3) and np.isfinite(shifts).all()
    assert float((r.transpose(-1, -2) @ r - torch.eye(3)).abs().max()) < 1e-4
    res = grad_check.main(["--iters", "800", "--lr", "0.05"])
    assert res["loss_last"] < 0.5 * res["loss_first"]


# -- the scale-out slice (the gates of chip_smoke.py's phases) --
def test_moe_planenet_on_the_card_matches_the_cpu(cuda):
    """A small MoE PlaneNet (both dispatches): forward within 1e-5 of its
    scale, the same load-balance loss within rtol 1e-5."""
    from diffusion_extensions_tpu_torch.models.planenet import PlaneNet

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 32, 3)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 100, 4))
    for dispatch in ("scatter", "onehot"):
        torch.manual_seed(0)
        model = PlaneNet(dim=64, heads=4, layers=2, moe_experts=4, moe_dispatch=dispatch)
        with torch.no_grad():
            ref, ref_aux = model(x, t), float(model.moe_aux())
            got = model.to(cuda)(x.to(cuda), t.to(cuda)).cpu()
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
        np.testing.assert_allclose(float(model.moe_aux()), ref_aux, rtol=1e-5)


def test_moe_step_replays_to_the_bits_of_eager_steps(cuda):
    """Eight MoE aircraft steps (dim 64, scatter dispatch, bf16) replayed
    from a CUDA graph give the weights of eight eager steps."""
    from diffusion_extensions_tpu_torch.experiments import aircraft
    from diffusion_extensions_tpu_torch.parallel.dp import make_dp_train_step
    from diffusion_extensions_tpu_torch.train.optim import make_optimizer
    from diffusion_extensions_tpu_torch.train.state import TrainState

    args = aircraft.parse_args(["--so3", "--dim", "64", "--layers", "2", "--timesteps", "100",
                                "--moe-experts", "4", "--bf16"])
    batches = torch.randn(8, 8, 32, 3, generator=torch.Generator().manual_seed(0)).to(cuda)
    weights = []
    for k in (1, 4):
        model, process = aircraft.build(args, cuda)
        opt = make_optimizer(model.named_parameters(), 1e-3)
        step = make_dp_train_step(aircraft.make_loss_fn(model, process), model, opt,
                                  steps_per_call=k)
        state = TrainState(model, opt, torch.Generator(device=cuda).manual_seed(1))
        for i in range(0, 8, k):
            state, _ = step(state, batches[i] if k == 1 else batches[i:i + k])
        weights.append(model.state_dict())
    for name, w in weights[0].items():
        assert torch.equal(w, weights[1][name]), name


def test_dsv2_trunk_step_replays_to_the_bits_of_eager_steps(cuda, monkeypatch):
    """Eight aircraft steps of PlaneNet with a small DeepSeek-V2 trunk (bf16,
    MLA, 8 of 16 experts held, top 4, the grouped products' dispatch)
    replayed from a CUDA graph give the weights and losses of eight eager
    steps, and the device counters count every replayed step."""
    from dataclasses import replace

    from diffusion_extensions_tpu_torch.experiments import aircraft
    from diffusion_extensions_tpu_torch.models.deepseek_v2 import DEEPSEEK_V2_LITE
    from diffusion_extensions_tpu_torch.parallel.dp import make_dp_train_step
    from diffusion_extensions_tpu_torch.train.optim import make_optimizer
    from diffusion_extensions_tpu_torch.train.state import TrainState

    small = replace(DEEPSEEK_V2_LITE, hidden_size=256, num_attention_heads=4, qk_nope_head_dim=32,
                    qk_rope_head_dim=16, v_head_dim=32, kv_lora_rank=64, intermediate_size=512,
                    moe_intermediate_size=128, n_routed_experts=16, num_experts_per_tok=4,
                    num_hidden_layers=3, experts_held=8)
    monkeypatch.setitem(aircraft.TRUNKS, "small", small)
    args = aircraft.parse_args(["--so3", "--timesteps", "100", "--trunk", "small", "--bf16"])
    batches = torch.randn(8, 8, 32, 3, generator=torch.Generator().manual_seed(0)).to(cuda)
    weights, losses, rows = [], [], []
    for k in (1, 8):
        obs.reset()
        model, process = aircraft.build(args, cuda)
        opt = make_optimizer(model.named_parameters(), 1e-3, impl="fused")
        step = make_dp_train_step(aircraft.make_loss_fn(model, process), model, opt, steps_per_call=k)
        state = TrainState(model, opt, torch.Generator(device=cuda).manual_seed(1))
        out = []
        for i in range(0, 8, k):
            state, m = step(state, batches[i] if k == 1 else batches[i:i + k])
            out.append(m["loss"].clone())
        weights.append(model.state_dict())
        losses.append(torch.stack(out[-1:]))
        rows.append(obs.snapshot()["counters"])
    for name, w in weights[0].items():
        assert torch.equal(w, weights[1][name]), name
    assert torch.equal(losses[0], losses[1])
    assert rows[0]["moe.layer_steps"] == rows[1]["moe.layer_steps"] == 8 * 2
    assert rows[0]["moe.rows"] == rows[1]["moe.rows"] > 0
    assert rows[1]["moe.captures"] == 2 and rows[1]["moe.graph_kernels"] > 0
    # the row passes ran as kernels: 6 a MoE layer and step eagerly, once at capture
    assert rows[0]["ops.moe_rows.launches"] == 8 * 2 * 6
    assert rows[1]["ops.moe_rows.launches"] == 2 * 2 * 6


def test_nccl_world_of_one_replays_its_all_reduce(cuda):
    """A NCCL group of one made in this process: K = 4 replayed steps
    through the all-reduce give the bits of the steps without a group, and
    the all-reduce was issued while the step was captured."""
    import torch.distributed as dist

    from diffusion_extensions_tpu_torch.experiments import aircraft
    from diffusion_extensions_tpu_torch.parallel.dp import make_dp_train_step
    from diffusion_extensions_tpu_torch.train.optim import make_optimizer
    from diffusion_extensions_tpu_torch.train.state import TrainState

    args = aircraft.parse_args(["--so3", "--dim", "64", "--layers", "2", "--timesteps", "100"])
    batches = torch.randn(8, 8, 32, 3, generator=torch.Generator().manual_seed(0)).to(cuda)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    capturing, all_reduce = [], dist.all_reduce

    def recorded(*a, **kw):
        capturing.append(torch.cuda.is_current_stream_capturing())
        return all_reduce(*a, **kw)

    try:
        dist.all_reduce = recorded
        weights = []
        for group in (None, dist.group.WORLD):
            model, process = aircraft.build(args, cuda)
            opt = make_optimizer(model.named_parameters(), 1e-3)
            step = make_dp_train_step(aircraft.make_loss_fn(model, process), model, opt,
                                      steps_per_call=4, group=group)
            state = TrainState(model, opt, torch.Generator(device=cuda).manual_seed(1))
            for i in range(0, 8, 4):
                state, _ = step(state, batches[i:i + 4])
            weights.append(model.state_dict())
    finally:
        dist.all_reduce = all_reduce
        dist.destroy_process_group()
    assert sum(capturing) == 1
    for name, w in weights[0].items():
        assert torch.equal(w, weights[1][name]), name


@pytest.fixture
def spans(cuda):
    """Spans on the card for one test, then off and cleared."""
    obs.reset()
    yield cuda
    obs.disable()
    obs.reset()


def _aircraft_calls(cuda, calls: int, on: bool, profile_last: bool = False):
    """``calls`` K = 8 calls of a small bf16 aircraft step (spans on or
    off from the build on): the losses, the weights, the counters after the
    first call, a snapshot of the last call alone and, with
    ``profile_last``, the profiler's device kernels in it."""
    from diffusion_extensions_tpu_torch.experiments import aircraft
    from diffusion_extensions_tpu_torch.parallel.dp import make_dp_train_step
    from diffusion_extensions_tpu_torch.train.optim import make_optimizer
    from diffusion_extensions_tpu_torch.train.state import TrainState

    if on:
        obs.enable(cuda)
    args = aircraft.parse_args(["--so3", "--bf16", "--dim", "128", "--layers", "2",
                                "--timesteps", "100"])
    batches = torch.randn(calls, 8, 8, 64, 3, generator=torch.Generator().manual_seed(0)).to(cuda)
    model, process = aircraft.build(args, cuda)
    opt = make_optimizer(model.named_parameters(), 1e-3)
    step = make_dp_train_step(aircraft.make_loss_fn(model, process), model, opt, steps_per_call=8)
    state = TrainState(model, opt, torch.Generator(device=cuda).manual_seed(1))
    losses, counters, kernels = [], None, None
    for i in range(calls):
        if i == calls - 1:
            torch.cuda.synchronize()
            counters = obs.snapshot()["counters"]
            obs.reset()
        if profile_last and i == calls - 1:
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                state, m = step(state, batches[i])
                torch.cuda.synchronize()
            kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                       and not e.name.startswith("dxt::")]
        else:
            state, m = step(state, batches[i])
        losses.append(m["loss"].clone())
    snap = obs.snapshot()
    return losses, [p.detach().clone() for p in model.parameters()], counters, snap, kernels


def test_replayed_steps_stamp_a_row_each_in_order(spans):
    """Spans on: one K = 8 call of replays writes 8 rows, each with the
    four phases in order, positive and covering at least 98% of the step,
    and the losses and weights are those of the same steps with spans off."""
    off_losses, off_params, off_counters, _, _ = _aircraft_calls(spans, 2, on=False)
    obs.reset()
    on_losses, on_params, counters, snap, _ = _aircraft_calls(spans, 2, on=True)
    for a, b in zip(off_losses + off_params, on_losses + on_params):
        assert torch.equal(a, b)
    assert off_counters["train.graph_kernels"] == counters["train.graph_kernels"] > 0
    assert counters["train.captures"] == 1 and counters["train.eager_steps"] == 1
    assert counters["train.replays"] == 7
    dev = snap["device"]
    assert dev["rows"] == 8 and dev["dropped"] == 0
    phases = ["process.noise", "model.forward", "train.backward", "train.optimizer"]
    s = {n: dev["spans"][n]["start"] for n in ["train.step", *phases]}
    e = {n: dev["spans"][n]["end"] for n in ["train.step", *phases]}
    for r in range(8):
        chain = [s["train.step"][r]] + [t for n in phases for t in (s[n][r], e[n][r])] + [e["train.step"][r]]
        assert chain == sorted(chain) and all(e[n][r] > s[n][r] for n in phases)
        covered = sum(e[n][r] - s[n][r] for n in phases)
        assert covered >= 0.98 * (e["train.step"][r] - s["train.step"][r])
    assert len(obs.gaps_us(snap)) == 7 and len(obs.host_ns(snap, "train.replay")) == 8


def test_graph_kernels_counts_the_replayed_kernels(spans):
    """``train.graph_kernels`` (read from the graph at capture, stamps left
    out) equals the device operations the profiler sees a replay, less the
    stamps and the four a replay runs outside its graph: the copy into the
    static batch, the loss's clone and the two fills of the generator's
    seed and offset."""
    _, _, counters, _, kernels = _aircraft_calls(spans, 2, on=True, profile_last=True)
    stamps = sum("obs_stamp" in k for k in kernels)
    assert stamps == 8 * 6
    assert len(kernels) - stamps == 8 * (counters["train.graph_kernels"] + 4)


# Adam's update kernel (ops/adam_cuda.py): leaves of 1, 3, 4095, 4097 and
# 1,048,577 elements, a leaf of zero gradients, one of 1e-12 gradients, an
# empty leaf, and one whose parameter and gradient sit one element off a
# 16-byte boundary (the kernel's element-at-a-time path)
ADAM_LEAVES = {"one": 1, "three": 3, "below": 4095, "above": 4097, "big": 1_048_577,
               "zeros": 4096, "tiny": 1000, "empty": 0, "offset": 4098}
ADAM_STEPS = 20


def _adam_params(cuda, seed):
    rng = np.random.default_rng(seed)
    out = []
    for name, n in ADAM_LEAVES.items():
        w = torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 0.05)
        if name == "offset":
            buf = torch.zeros(n + 1, device=cuda)
            buf[1:] = w.to(cuda)
            out.append((name, torch.nn.Parameter(buf[1:])))
        else:
            out.append((name, torch.nn.Parameter(w.to(cuda))))
    return out


def _adam_grads(cuda, step):
    """Step ``step``'s gradients: their norm crosses 1 both ways over the
    sequence (every third step is 100x smaller), so a clip at 1.0 both
    scales and leaves alone."""
    rng = np.random.default_rng(500 + step)
    scale = 1e-4 if step % 3 == 0 else 1e-2
    out = {}
    for name, n in ADAM_LEAVES.items():
        g = rng.standard_normal(n).astype(np.float32) * scale
        if name == "zeros":
            g[:] = 0.0
        elif name == "tiny":
            g *= 1e-12 / scale
        g = torch.from_numpy(g).to(cuda)
        if name == "offset":
            buf = torch.empty(n + 1, device=cuda)
            buf[1:] = g
            g = buf[1:]
        out[name] = g
    return out


def _plain_step(opt, monkeypatch):
    """``opt.step()`` through the plain version on the card."""
    from diffusion_extensions_tpu_torch.ops import adam_cuda
    from diffusion_extensions_tpu_torch.train import optim

    with monkeypatch.context() as m:
        m.setattr(optim, "adam_update", adam_cuda.adam_update_ref)
        opt.step()


ADAM_CASES = [
    pytest.param(impl, clip, schedule, dtype, id=f"{impl}-{dtype}-clip{clip}-{schedule}")
    for impl, dtype in (("optax", "f32"), ("fused", "f32"), ("fused", "bf16"))
    for clip in (0.0, 1.0) for schedule in ("const", "cosine")]


@pytest.mark.parametrize("impl,clip,schedule,state_dtype", ADAM_CASES)
def test_adam_kernel_matches_plain_version(cuda, monkeypatch, impl, clip, schedule, state_dtype):
    """Every implementation, moment dtype, clip and schedule the factory
    takes: 20 steps of the kernel against 20 of the plain version on the
    card from the same weights and gradients.  The kernel rounds each
    operation as the plain version's PyTorch kernel does on the card (an
    explicit round-to-nearest intrinsic each, the fused order's two moment
    updates as PyTorch's one fused multiply-add each, bf16 moments rounded
    to nearest even at the store), so weights and moments agree to the bit
    after every step; one launch a step."""
    from diffusion_extensions_tpu_torch.train.optim import make_optimizer

    kw = dict(clip=clip, schedule=schedule, total_steps=ADAM_STEPS // 2, impl=impl,
              state_dtype=state_dtype)
    mine, ref = _adam_params(cuda, 1), _adam_params(cuda, 1)
    kernel, plain = make_optimizer(mine, 1e-2, **kw), make_optimizer(ref, 1e-2, **kw)
    for step in range(ADAM_STEPS):
        grads = _adam_grads(cuda, step)
        for (name, p), (_, q) in zip(mine, ref):
            p.grad, q.grad = grads[name], grads[name].clone()
        before = obs.counter("ops.adam.launches")
        kernel.step()
        assert obs.counter("ops.adam.launches") == before + 1
        _plain_step(plain, monkeypatch)
        torch.cuda.synchronize()
        for (name, p), (_, q) in zip(mine, ref):
            assert torch.equal(p, q), f"step {step}, leaf {name}"
        for a, b, name in zip(kernel.mu + kernel.nu, plain.mu + plain.nu, kernel.names * 2):
            assert a.dtype == b.dtype and torch.equal(a, b), f"step {step}, moment of {name}"
    assert int(kernel.count) == int(plain.count) == ADAM_STEPS
    moved = {n: float((p.detach() - q.detach()).abs().max())
             for (n, p), (_, q) in zip(mine, _adam_params(cuda, 1)) if p.numel()}
    assert all(moved[n] > 0 for n in ("one", "three", "big", "offset", "tiny"))
    assert moved["zeros"] == 0.0


def test_adam_kernel_splits_a_table_of_many_leaves(cuda, monkeypatch):
    """More leaves than one launch's table holds (``MAX_LEAVES``): two
    launches, the same bits as the plain version."""
    from diffusion_extensions_tpu_torch.ops import adam_cuda
    from diffusion_extensions_tpu_torch.train.optim import make_optimizer

    rng = np.random.default_rng(7)
    sizes = rng.integers(0, 3 * adam_cuda.CHUNK, adam_cuda.MAX_LEAVES + 30)
    inits = [torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda) for n in sizes]
    grads = [torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda) for n in sizes]
    mine = [(f"w{i}", torch.nn.Parameter(w.clone())) for i, w in enumerate(inits)]
    ref = [(f"w{i}", torch.nn.Parameter(w.clone())) for i, w in enumerate(inits)]
    kernel = make_optimizer(mine, 1e-3, impl="fused", state_dtype="bf16", clip=1.0)
    plain = make_optimizer(ref, 1e-3, impl="fused", state_dtype="bf16", clip=1.0)
    for (_, p), (_, q), g in zip(mine, ref, grads):
        p.grad, q.grad = g, g.clone()
    before = obs.counter("ops.adam.launches")
    kernel.step()
    assert obs.counter("ops.adam.launches") == before + 2
    _plain_step(plain, monkeypatch)
    torch.cuda.synchronize()
    for (_, p), (_, q) in zip(mine, ref):
        assert torch.equal(p, q)
    for a, b in zip(kernel.mu + kernel.nu, plain.mu + plain.nu):
        assert torch.equal(a, b)


def test_adam_kernel_refuses_leaves_it_cannot_take(cuda):
    """A bf16 parameter, moments of two dtypes, a leaf that is not dense,
    a gradient laid out otherwise than its parameter, a leaf on the CPU,
    bf16 moments in the plain chain's order: each raises, and nothing is
    launched."""
    from diffusion_extensions_tpu_torch.ops.adam_cuda import adam_update

    one = torch.ones((), device=cuda)
    f32 = lambda *s: torch.zeros(*s, device=cuda)  # noqa: E731
    cases = {
        "bf16 parameter": ([f32(8).bfloat16()], [f32(8).bfloat16()], [f32(8)], [f32(8)], TypeError),
        "moment dtypes": ([f32(8)], [f32(8)], [f32(8)], [f32(8).bfloat16()], TypeError),
        "not dense": ([f32(8, 8)[:, ::2]], [f32(8, 8)[:, ::2]], [f32(8, 8)[:, ::2]],
                      [f32(8, 8)[:, ::2]], ValueError),
        "other layout": ([f32(4, 4)], [f32(4, 4).t()], [f32(4, 4)], [f32(4, 4)], ValueError),
        "on the CPU": ([f32(8)], [torch.zeros(8)], [f32(8)], [f32(8)], ValueError),
        "bf16 moments in the plain chain": ([f32(8)], [f32(8)], [f32(8).bfloat16()],
                                            [f32(8).bfloat16()], ValueError),
    }
    before = obs.counter("ops.adam.launches")
    for name, (p, g, m, v, error) in cases.items():
        with pytest.raises(error):
            adam_update(p, g, m, v, one, one, one, None, impl="optax", b1=0.9, b2=0.999,
                        eps=1e-8, clip=0.0)
    assert obs.counter("ops.adam.launches") == before


# The experts layer's row passes (ops/moe_rows_cuda.py) at the
# dsv2lite-aircraft-train cell's shapes: T 16,384 tokens, top 6 of 64
# experts, 8 held, d 2,048, f 1,408.  HELD_BIAS lowers the held experts'
# scores so that about 10,330 of the T k = 98,304 rows are held, as the
# cell's untrained router holds them.
MOE_CELL = dict(t=16_384, k=6, e=64, held=8, d=2048, f=1408)
HELD_BIAS = -0.105


def _moe_plan(cuda, case, seed=0, t=MOE_CELL["t"], k=MOE_CELL["k"], e=MOE_CELL["e"]):
    """(order, inv, offs, held_mask (T, k)) of a routing drawn on the card:
    ``"cell"`` ~10.5% of the choices held, token 0 holding all its k
    choices and token 1 none; ``"none"`` no choice held (n = 0); ``"all"``
    every expert held (n = T k, as with experts_held = n_routed_experts)."""
    from diffusion_extensions_tpu_torch.ops import moe_rows_cuda as mr

    held = e if case == "all" else MOE_CELL["held"]
    gen = torch.Generator(device=cuda).manual_seed(seed)
    scores = torch.randn(t, e, generator=gen, device=cuda)
    if case == "cell":
        scores[:, :held] += HELD_BIAS
        scores[0, :held] += 100.0
        scores[1, :held] -= 100.0
    elif case == "none":
        scores[:, :held] -= 100.0
    top_i = scores.topk(k, dim=-1).indices
    order, inv, _, offs = mr.dispatch_plan(top_i, 0, held)
    return order, inv, offs, top_i < held


def _nan_past(x, n):
    x[n:] = float("nan")
    return x


def _moe_operands(cuda, case, seed=0, dtype=torch.bfloat16, t=MOE_CELL["t"], k=MOE_CELL["k"],
                  d=MOE_CELL["d"], f=MOE_CELL["f"]):
    """The routing, its n, and every pass's inputs and incoming gradients,
    rows past n filled with NaN."""
    order, inv, offs, mine = _moe_plan(cuda, case, seed, t=t, k=k)
    n = int(offs[-1])
    gen = torch.Generator(device=cuda).manual_seed(seed + 1)
    r = t * k

    def rnd(*shape, dt=dtype):
        return torch.randn(*shape, generator=gen, device=cuda).to(dt)

    return dict(order=order, inv=inv, offs=offs, mine=mine, n=n,
                tokens=rnd(t, d, dt=torch.float32), w=torch.rand(t, k, generator=gen, device=cuda),
                grad_xs=_nan_past(rnd(r, d), n), h1=_nan_past(rnd(r, 2 * f), n),
                grad_h=_nan_past(rnd(r, f), n), ys=_nan_past(rnd(r, d), n),
                grad_out=rnd(t, d, dt=torch.float32))


def _grads(out, inputs, grad):
    return torch.autograd.grad(out, inputs, grad)


@pytest.mark.parametrize("case", ["cell", "none", "all"])
def test_moe_rows_kernels_match_plain_versions(cuda, case):
    """Each kernel, forward and backward, against its plain version on the
    card at the cell's shapes, rows past n NaN in every input: the rows
    under n and the per-token results equal the plain version's to the bit
    (each rounds as PyTorch's kernels do, a token's k rows summed in the
    order of PyTorch's reduction), all finite.  The combine's gradient of
    the weights is a float32 dot product over d summed in another order
    than PyTorch's: within 2 d 2^-24 sum |g y| of it, the bound of two
    orders' rounding; 0 where a choice is not held.  Six launches."""
    from diffusion_extensions_tpu_torch.ops import moe_rows_cuda as mr

    ops = _moe_operands(cuda, case)
    n, order, inv, offs, mine = ops["n"], ops["order"], ops["inv"], ops["offs"], ops["mine"]
    t, k = mine.shape
    assert {"cell": 0 < n < t * k // 8, "none": n == 0, "all": n == t * k}[case]
    if case == "cell":
        assert bool(mine[0].all()) and not bool(mine[1].any())
    before = obs.counter("ops.moe_rows.launches")
    got, want = {}, {}
    for name, fn in (("kernel", mr), ("plain", None)):
        res = got if fn else want
        tokens = ops["tokens"].clone().requires_grad_(True)
        xs = (mr.gather(tokens, order, inv, offs, torch.bfloat16) if fn else
              mr.gather_ref(tokens, order, inv, offs, torch.bfloat16))
        res["xs"] = xs.detach()[:n]
        (res["tokens"],) = _grads(xs, [tokens], ops["grad_xs"])
        h1 = ops["h1"].clone().requires_grad_(True)
        h = mr.swiglu(h1, offs) if fn else mr.swiglu_ref(h1)
        res["h"] = h.detach()[:n]
        (dh1,) = _grads(h, [h1], ops["grad_h"])
        res["h1"] = dh1[:n]
        ys = ops["ys"].clone().requires_grad_(True)
        w = ops["w"].clone().requires_grad_(True)
        out = mr.combine(ys, w, inv, offs) if fn else mr.combine_ref(ys, w, inv, offs)
        res["out"] = out.detach()
        res["ys"], res["w"] = _grads(out, [ys, w], ops["grad_out"])
        res["ys"] = res["ys"][:n]
    torch.cuda.synchronize()
    assert obs.counter("ops.moe_rows.launches") == before + 6
    for key in ("xs", "tokens", "h", "h1", "out", "ys"):
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        assert torch.isfinite(got[key]).all(), key
        assert torch.equal(got[key], want[key]), key
    ys_rows = ops["ys"].float().index_select(0, inv).view(t, k, -1)
    scale = torch.where(mine, (ops["grad_out"][:, None, :] * ys_rows).abs().sum(-1), 0.0)
    assert torch.isfinite(got["w"]).all()
    assert ((got["w"] - want["w"]).abs() <= 2 * MOE_CELL["d"] * 2.0**-24 * scale).all()
    assert not got["w"][~mine].any()


def test_moe_rows_kernels_touch_no_row_past_n(cuda):
    """Each launch into outputs filled with NaN: the rows past n keep their
    NaN bits (never written), the rows under n and every per-token output
    are written and finite, though every input row past n is NaN (never
    read)."""
    from diffusion_extensions_tpu_torch.ops import moe_rows_cuda as mr

    ops = _moe_operands(cuda, "cell", seed=3)
    n, inv, offs = ops["n"], ops["inv"], ops["offs"]
    t, k = ops["mine"].shape
    d, f = MOE_CELL["d"], MOE_CELL["f"]

    def nans(*shape, dt=torch.bfloat16):
        return torch.full(shape, float("nan"), device=cuda, dtype=dt)

    xs, h, dh1, grad_ys = nans(t * k, d), nans(t * k, f), nans(t * k, 2 * f), nans(t * k, d)
    tok_grad, out, grad_w = nans(t, d, dt=torch.float32), nans(t, d, dt=torch.float32), nans(t, k, dt=torch.float32)
    mr.launch_gather(ops["tokens"], ops["order"], offs, xs)
    mr.launch_gather_backward(ops["grad_xs"], inv, offs, tok_grad)
    mr.launch_swiglu(ops["h1"], offs, h)
    mr.launch_swiglu_backward(ops["grad_h"], ops["h1"], offs, dh1)
    mr.launch_combine(ops["ys"], ops["w"], inv, offs, out)
    mr.launch_combine_backward(ops["grad_out"], ops["ys"], ops["w"], inv, offs, grad_ys, grad_w)
    torch.cuda.synchronize()
    for name, x in (("xs", xs), ("h", h), ("dh1", dh1), ("grad_ys", grad_ys)):
        assert torch.isfinite(x[:n]).all(), name
        assert torch.isnan(x[n:]).all(), name
    for name, x in (("tokens' gradient", tok_grad), ("out", out), ("grad_w", grad_w)):
        assert torch.isfinite(x).all(), name


def test_grouped_products_read_no_row_past_n(cuda):
    """What the kernels rest on: ``torch._grouped_mm`` with the groups'
    ends ``offs`` reads no row past n, forward or backward.  NaN in those
    rows of its input and of its incoming gradient leaves the rows under n
    and both gradients as they are with zeros there."""
    order, _, offs, _ = _moe_plan(cuda, "cell", seed=5)
    n, r = int(offs[-1]), order.numel()
    d, f = MOE_CELL["d"], MOE_CELL["f"]
    gen = torch.Generator(device=cuda).manual_seed(6)
    weight = (torch.randn(MOE_CELL["held"], d, 2 * f, generator=gen, device=cuda) * d**-0.5).bfloat16()
    x = torch.randn(r, d, generator=gen, device=cuda).bfloat16()
    g = torch.randn(r, 2 * f, generator=gen, device=cuda).bfloat16()
    results = []
    for fill in (0.0, float("nan")):
        xx, ww, gg = x.clone(), weight.clone().requires_grad_(True), g.clone()
        xx[n:], gg[n:] = fill, fill
        xx.requires_grad_(True)
        y = torch._grouped_mm(xx, ww, offs=offs)
        dx, dw = torch.autograd.grad(y, [xx, ww], gg)
        results.append((y[:n], dx[:n], dw))
    for a, b in zip(*results):
        assert torch.isfinite(b).all() and torch.equal(a, b)


def test_moe_rows_kernels_take_float32_rows(cuda):
    """Without autocast the rows stay float32: the same kernels, bit-equal
    to the plain versions (at a smaller size)."""
    from diffusion_extensions_tpu_torch.ops import moe_rows_cuda as mr

    ops = _moe_operands(cuda, "cell", seed=7, dtype=torch.float32, t=2048, d=256, f=128)
    n, order, inv, offs = ops["n"], ops["order"], ops["inv"], ops["offs"]
    pairs = []
    for fn in (True, False):
        tokens = ops["tokens"].clone().requires_grad_(True)
        xs = (mr.gather if fn else mr.gather_ref)(tokens, order, inv, offs, torch.float32)
        (dt,) = _grads(xs, [tokens], ops["grad_xs"])
        h1 = ops["h1"].clone().requires_grad_(True)
        h = mr.swiglu(h1, offs) if fn else mr.swiglu_ref(h1)
        (dh1,) = _grads(h, [h1], ops["grad_h"])
        ys = ops["ys"].clone().requires_grad_(True)
        out = (mr.combine if fn else mr.combine_ref)(ys, ops["w"], inv, offs)
        (dys,) = _grads(out, [ys], ops["grad_out"])
        pairs.append((xs[:n], dt, h[:n], dh1[:n], out, dys[:n]))
    for a, b in zip(*pairs):
        assert a.dtype == torch.float32 and torch.isfinite(a).all() and torch.equal(a, b)


def test_moe_rows_wrappers_refuse_what_the_kernels_cannot_take(cuda):
    """float16 rows, a width off a multiple of 8, more than MAX_K choices,
    operands on two devices: each raises, and nothing is launched."""
    from diffusion_extensions_tpu_torch.ops import moe_rows_cuda as mr

    offs = torch.tensor([4, 8], dtype=torch.int32, device=cuda)
    idx = torch.arange(32, device=cuda)
    before = obs.counter("ops.moe_rows.launches")
    with pytest.raises(TypeError):
        mr.swiglu(torch.zeros(32, 32, device=cuda, dtype=torch.float16), offs)
    with pytest.raises(ValueError):
        mr.gather(torch.zeros(4, 20, device=cuda), idx, idx, offs, torch.bfloat16)
    with pytest.raises(ValueError):
        mr.combine(torch.zeros(36, 16, device=cuda, dtype=torch.bfloat16), torch.zeros(4, 9, device=cuda),
                   torch.arange(36, device=cuda), offs)
    with pytest.raises(ValueError):
        mr.combine(torch.zeros(32, 16, device=cuda, dtype=torch.bfloat16), torch.zeros(4, 8, device=cuda),
                   idx, offs.cpu())
    assert obs.counter("ops.moe_rows.launches") == before
