"""The port's gates on the card; they need an NVIDIA GPU and skip without one.

Each CUDA kernel against its plain PyTorch version (at the sizes
``chip_smoke.py`` times too), and the card against the CPU at small sizes,
same weights and inputs.  On a machine with a card (and without JAX: the
tests' ``conftest.py`` imports it), run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

This file imports torch and the port only.
"""
import copy
import functools

import numpy as np
import pytest
import torch

from diffusion_extensions_tpu_torch import obs
from diffusion_extensions_tpu_torch.data.jigsaw import JigsawPuzzle, puzzle_rows
from diffusion_extensions_tpu_torch.data.pdb import pad_prot_batch, synthetic_prot_pair, to_device
from diffusion_extensions_tpu_torch.data.synthetic import bingham_dist
from diffusion_extensions_tpu_torch.experiments import aircraft, diagnostics, grad_check, jigsaw, lock, protein
from diffusion_extensions_tpu_torch.models.coordconv import CoordConv
from diffusion_extensions_tpu_torch.models.planenet import PlaneNet
from diffusion_extensions_tpu_torch.models.projections import PointCloudProj, ProtProjection
from diffusion_extensions_tpu_torch.models.protnet import ProtNet
from diffusion_extensions_tpu_torch.models.rot_predict import RotPredict
from diffusion_extensions_tpu_torch.ops import adam_cuda, igso3_cuda, metrics, mmd_cuda
from diffusion_extensions_tpu_torch.ops import mla_attention_cuda as mla
from diffusion_extensions_tpu_torch.ops import moe_rows_cuda as mr
from diffusion_extensions_tpu_torch.ops.igso3 import IGSO3xR3
from diffusion_extensions_tpu_torch.ops.se3 import AffineT
from diffusion_extensions_tpu_torch.ops.so3 import exp_skewvec, haar_rotations, quat_to_rmat, rmat_to_euler
from diffusion_extensions_tpu_torch.parallel.dp import make_dp_train_step
from diffusion_extensions_tpu_torch.processes.euler import ProjectedEulerDiffusion
from diffusion_extensions_tpu_torch.processes.r3 import ProjectedGaussianDiffusion
from diffusion_extensions_tpu_torch.processes.se3 import ProjectedSE3Diffusion
from diffusion_extensions_tpu_torch.processes.so3 import ProjectedSO3Diffusion, SO3Diffusion
from diffusion_extensions_tpu_torch.train import optim
from diffusion_extensions_tpu_torch.train.optim import make_optimizer
from diffusion_extensions_tpu_torch.train.state import TrainState

pytestmark = pytest.mark.cuda

# each kernel's gates against its plain version, as the kernel's module states them
LOGF, SCORE = (dict(zip(("rtol", "atol"), igso3_cuda.GATES[k])) for k in ("logf", "score"))
SUM = dict(zip(("rtol", "atol"), mmd_cuda.GATES["sum"]))


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


@pytest.mark.parametrize("n", [16, 32, 1000, 20_000, 2**20, 2**20 + 37])
def test_kernel_matches_plain_version(cuda, n):
    """Gates of tests/test_pallas.py: log f rtol/atol 1e-5; score rtol 1e-4,
    atol 5e-4."""
    t, s = _inputs(n, n, cuda)
    before = obs.counter("ops.igso3.launches")
    logf, score = igso3_cuda.igso3_logpdf_score(t, s)
    torch.cuda.synchronize()
    assert obs.counter("ops.igso3.launches") == before + 1
    ref_logf, ref_score = igso3_cuda.igso3_logpdf_score_ref(t, s)
    torch.testing.assert_close(logf, ref_logf, **LOGF)
    torch.testing.assert_close(score, ref_score, **SCORE)
    # and against the plain version on the CPU
    c_logf, c_score = igso3_cuda.igso3_logpdf_score_ref(t.cpu(), s.cpu())
    torch.testing.assert_close(logf.cpu(), c_logf, **LOGF)
    torch.testing.assert_close(score.cpu(), c_score, **SCORE)


def test_kernel_broadcasts(cuda):
    t = torch.linspace(0.1, 3.0, 7, device=cuda).reshape(7, 1)
    logf, score = igso3_cuda.igso3_logpdf_score(t, torch.tensor([0.5], device=cuda))
    assert logf.shape == (7, 1) and score.shape == (7, 1)
    ref_logf, _ = igso3_cuda.igso3_logpdf_score_ref(t.cpu(), torch.tensor([0.5]))
    torch.testing.assert_close(logf.cpu(), ref_logf, **LOGF)


def test_kernel_refuses_other_dtypes(cuda):
    with pytest.raises(TypeError):
        igso3_cuda.igso3_logpdf_score(torch.zeros(4, device=cuda, dtype=torch.float64),
                                      torch.ones(4, device=cuda, dtype=torch.float64))


def _hold_to_plain(logf, score, t, s):
    """The gates (``igso3_cuda.GATES``: log f rtol/atol 1e-5; score rtol
    1e-4, atol 5e-4) against the plain version on the card, which rounds as
    the kernel's exact path does, and on the CPU.  Against the CPU's math library the score's atol
    is max(5e-4, 2 ulp(1/t)) for t >= 1e-4: there the score is a difference
    of two terms of size 1/t, each rounded on its own, so two correct
    evaluations may differ by an ulp of 1/t in each.  That is 5e-4 from
    t = 4.9e-4 up and at most 1.95e-3 (at t = 1e-4)."""
    ref_logf, ref_score = igso3_cuda.igso3_logpdf_score_ref(t, s)
    torch.testing.assert_close(logf, ref_logf, **LOGF)
    torch.testing.assert_close(score, ref_score, **SCORE)
    t, s = t.cpu(), s.cpu()
    ref_logf, ref_score = igso3_cuda.igso3_logpdf_score_ref(t, s)
    torch.testing.assert_close(logf.cpu(), ref_logf, **LOGF)
    inv = 1.0 / t.clamp(min=1e-4)
    ulp = torch.nextafter(inv, torch.full_like(inv, float("inf"))) - inv
    atol = torch.where(t >= 1e-4, (2.0 * ulp).clamp(min=SCORE["atol"]),
                       torch.full_like(inv, SCORE["atol"]))
    excess = (score.cpu() - ref_score).abs() - (atol + SCORE["rtol"] * ref_score.abs())
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
    allocated = torch.cuda.memory_stats(cuda)["allocation.all.allocated"]
    logf, score = igso3_cuda.igso3_logpdf_score(t, sigma)
    # one allocation in the call: its outputs
    assert torch.cuda.memory_stats(cuda)["allocation.all.allocated"] - allocated == 1
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
    torch.testing.assert_close(score, ref_score, **SCORE)
    above = torch.tensor([lo, np.nextafter(lo, np.float32(1))], device=cuda).repeat(4)
    sig = torch.tensor([0.05, 0.4, 1.0, 1.5], device=cuda).repeat_interleave(2)
    assert igso3_cuda.cheap_domain(above, sig).all()
    _hold_to_plain(*igso3_cuda.igso3_logpdf_score(above, sig), above, sig)


def test_heun_sampler_launches_kernel_twice_per_step(cuda):
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


@pytest.mark.parametrize("n,m", [(1, 1), (257, 130), (300, 200), (4096, 1000), (4096, 4096),
                                 (20_000, 20_000)])
def test_mmd_kernel_matches_plain_version(cuda, n, m):
    """Gate of tests/test_pallas.py: rtol 1e-4 on the sum, on the card and
    against the plain version on the CPU (summed in blocks of 4000 x 4000);
    257 x 130 is the masking case, 20k x 20k the Bingham path's sums."""
    x, y = _rots(n, n, cuda), _rots(m, m + 1, cuda, 0.3)
    before = obs.counter("ops.mmd.launches")
    got = mmd_cuda.gaussian_kernel_sum(x, y)
    torch.cuda.synchronize()
    assert obs.counter("ops.mmd.launches") == before + 1
    assert got.shape == () and got.device == x.device
    torch.testing.assert_close(got, mmd_cuda.gaussian_kernel_sum_ref(x, y, 4000), **SUM)
    ref_cpu = mmd_cuda.gaussian_kernel_sum_ref(x.cpu(), y.cpu(), 4000)
    torch.testing.assert_close(got.cpu(), ref_cpu, **SUM)


def test_mmd_kernel_identity_and_pi_pairs(cuda):
    """X = Y (theta = 0 on the diagonal) and exact-pi relative rotations."""
    x = _rots(2000, 5, cuda)
    torch.testing.assert_close(mmd_cuda.gaussian_kernel_sum(x, x),
                               mmd_cuda.gaussian_kernel_sum_ref(x, x), **SUM)
    u = torch.nn.functional.normalize(torch.randn(500, 3, dtype=torch.float64), dim=-1)
    pi = (2.0 * u[:, :, None] * u[:, None, :] - torch.eye(3, dtype=torch.float64))
    y = (x[:500].double() @ pi.to(cuda)).float()
    got = mmd_cuda.gaussian_kernel_sum(x[:500], y)
    torch.testing.assert_close(got, mmd_cuda.gaussian_kernel_sum_ref(x[:500], y), **SUM)


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
    torch.testing.assert_close(got, mmd_cuda.gaussian_kernel_sum_ref(x, y), **SUM)
    torch.testing.assert_close(got.cpu(), mmd_cuda.gaussian_kernel_sum_ref(x.cpu(), y.cpu()),
                               **SUM)


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
    batches = _protein_batches(8)
    eager, step1, _ = _protein_setup(cuda, bf16)
    for b in batches:
        eager, m1 = step1(eager, to_device(b, cuda))
    graphed, step4, _ = _protein_setup(cuda, bf16, k=4)
    for i in (0, 4):
        graphed, m4 = step4(graphed, to_device(protein.stack_batches(batches[i : i + 4]), cuda))
    torch.cuda.synchronize()
    assert graphed.step == eager.step == 8
    assert float(m4["loss"]) == float(m1["loss"])
    for p, q in zip(graphed.model.parameters(), eager.model.parameters()):
        assert torch.equal(p, q)


def test_protein_heun_sampler_launches_kernel_twice_per_step(cuda):
    """The SE(3) Heun sampler's rotation score runs the IGSO(3) kernel once
    per model evaluation: 2 launches a step, none in the final estimate."""
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
    b = _protein_batches(1)[0]
    dev = to_device(b, cuda)
    assert dev.receptor_mask.dtype == torch.bool and dev.ligand.angles.is_cuda
    for got, want in ((dev.receptor.positions, b.receptor.positions),
                      (dev.ligand.angles, b.ligand.angles), (dev.ligand_mask, b.ligand_mask)):
        assert np.array_equal(got.cpu().numpy(), want)


# -- the card against the CPU at small sizes: the same weights and inputs --
def _scale_head(layer, by=0.1):
    """Scales an output layer so that an untrained model's chain is not chaotic."""
    with torch.no_grad():
        layer.weight.mul_(by)
        layer.bias.mul_(by)


def _train_losses(loss_fn, model, dev, batches, **kw):
    """The loss of each eager Adam step (lr 1e-3) over ``batches``."""
    opt = make_optimizer(model.named_parameters(), 1e-3)
    step = make_dp_train_step(loss_fn, model, opt, **kw)
    state, out = TrainState(model, opt, torch.Generator(device=dev)), []
    for batch in batches:
        state, m = step(state, batch)
        out.append(float(m["loss"]))
    return out


def _rel(a, b):
    return max(abs(x - y) / abs(x) for x, y in zip(a, b))


def test_heun_sampler_on_the_card_matches_the_cpu(cuda):
    """The Heun sampler, the kernel on the card against the plain version on
    the CPU: PlaneNet dim 64 / 2 layers (head scaled by 0.1), B 4, N 32,
    T 50, 10 steps from one x_init; 1e-3 on rotation entries."""
    torch.manual_seed(3)
    model = PlaneNet(dim=64, heads=4, layers=2).eval()
    _scale_head(model.head)
    data = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 32, 3)).astype(np.float32))
    x_init = torch.linalg.qr(torch.randn(4, 3, 3))[0]
    outs = []
    for dev in ("cpu", cuda):
        with torch.inference_mode():
            outs.append(ProjectedSO3Diffusion(50, device=dev).pf_sample_loop(
                model.to(dev), None, (4,), 10, PointCloudProj(data.to(dev)), method="heun",
                x_init=x_init.to(dev)).cpu())
    assert float((outs[0] - outs[1]).abs().max()) < 1e-3


def test_bingham_slice_on_the_card_matches_the_cpu(cuda):
    """RotPredict d_model 65 (head scaled by 0.1), SO3Diffusion T = 50,
    DDIM-10 over 256 chains from one x_init: 1e-3 on rotation entries; the
    MMD of those samples against 256 Bingham ("lcr") targets, the kernel on
    the card against the plain version on the CPU: rtol 1e-3."""
    torch.manual_seed(5)
    model = RotPredict(65, "skewvec").eval()
    _scale_head(model.out)
    proc_cpu = SO3Diffusion.create(50, device="cpu")
    x_init = proc_cpu.prior_table.sample(torch.Generator().manual_seed(6), torch.zeros(256, dtype=torch.long))
    z = torch.from_numpy(np.random.default_rng(7).standard_normal((256, 4)).astype(np.float32))
    target = quat_to_rmat(bingham_dist("lcr", device="cpu").from_normal(z))
    outs, mmds = [], []
    for dev, proc in (("cpu", proc_cpu), (cuda, SO3Diffusion.create(50, device=cuda))):
        with torch.inference_mode():
            outs.append(proc.ddim_sample_loop(model.to(dev), None, (256,), 10, x_init=x_init.to(dev)).cpu())
            mmds.append(float(metrics.mmd(target.to(dev), outs[-1].to(dev))))
    assert float((outs[0] - outs[1]).abs().max()) < 1e-3
    assert _rel(mmds[:1], mmds[1:]) < 1e-3


def test_train_steps_on_the_card_match_the_cpu(cuda):
    """Five train steps: PlaneNet dim 32 / 2 heads / 1 layer, batch 8 x 16
    points, T = 100, the same init, clouds, t and noise (drawn once on the
    CPU): each step's loss within rtol 1e-4."""
    rng = np.random.default_rng(11)
    clouds = torch.from_numpy(rng.standard_normal((5, 8, 16, 3)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 100, (5, 8)))
    torch.manual_seed(11)
    init = PlaneNet(dim=32, heads=2, layers=1).state_dict()
    proc_cpu = ProjectedSO3Diffusion(100, device="cpu")
    gen = torch.Generator().manual_seed(12)
    noise = [proc_cpu.sample_noise(gen, t[i]) for i in range(5)]
    losses = []
    for dev, proc in (("cpu", proc_cpu), (cuda, ProjectedSO3Diffusion(100, device=cuda))):
        model = PlaneNet(dim=32, heads=2, layers=1)
        model.load_state_dict(init)
        model = model.to(dev)
        losses.append(_train_losses(aircraft.make_loss_fn(model, proc), model, dev,
                                    [(clouds[i].to(dev), t[i].to(dev), noise[i].to(dev)) for i in range(5)]))
    assert _rel(*losses) < 1e-4


def test_protein_slice_on_the_card_matches_the_cpu(cuda):
    """ProtNet dim 64 / 4 heads / t_depth 2 / c_depth 3 with every flag,
    float32, one init (head scaled by 0.1), 4 synthetic pairs of 40 / 20
    residues: the forward within rtol 1e-4 of its largest output; a DDIM-10
    chain at T = 50 from one x_init within 1e-3 on rotation entries and of
    1 + the largest |shift|; 5 Adam steps on the same batches, t and noise
    (drawn once on the CPU), each loss within rtol 1e-4."""
    cfg = dict(dim=64, heads=4, t_depth=2, c_depth=3, frame_pool=True, cross_depth=2, rel_frame=True,
               equiv_head=True)
    torch.manual_seed(13)
    init = ProtNet(**cfg)
    _scale_head(init.head_out)
    rng = np.random.default_rng(13)
    batch_np = pad_prot_batch([synthetic_prot_pair(rng, 40 - i, 20 - i) for i in range(4)])
    t_fwd = torch.tensor([0, 10, 30, 49])
    x_init = AffineT(haar_rotations(torch.Generator().manual_seed(14), (4,)),
                     torch.randn(4, 3, generator=torch.Generator().manual_seed(15)))
    proc_cpu = ProjectedSE3Diffusion(50, clip_shift=75.0, device="cpu")
    gen = torch.Generator().manual_seed(16)
    t_train = torch.randint(0, 50, (5, 4), generator=gen)
    noise = [proc_cpu.sample_noise(gen, t_train[i]) for i in range(5)]
    outs = []
    for dev in ("cpu", cuda):
        model = ProtNet(**cfg)
        model.load_state_dict(init.state_dict())
        model = model.to(dev)
        proc = proc_cpu if dev == "cpu" else ProjectedSE3Diffusion(50, clip_shift=75.0, device=dev)
        batch = to_device(batch_np, dev)
        proj = ProtProjection(batch)
        with torch.inference_mode():
            fwd = model.eval()(proj(AffineT.identity((4,), device=dev)), t_fwd.to(dev))
            chain = proc.ddim_sample_loop(model, None, (4,), 10, proj,
                                          x_init=AffineT(x_init.rot.to(dev), x_init.shift.to(dev)))
        losses = _train_losses(protein.make_loss_fn(model.train(), proc), model, dev, [
            (batch, t_train[i].to(dev), (noise[i].rot.to(dev), noise[i].shift.to(dev))) for i in range(5)])
        outs.append((torch.cat((fwd.rot_g, fwd.shift_g), -1).cpu(), chain.rot.cpu(), chain.shift.cpu(), losses))
    (f_c, r_c, s_c, l_c), (f_g, r_g, s_g, l_g) = outs
    assert float((f_c - f_g).abs().max()) < 1e-4 * float(f_c.abs().max())
    assert float((r_c - r_g).abs().max()) < 1e-3
    assert float((s_c - s_g).abs().max()) < 1e-3 * (1.0 + float(s_c.abs().max()))
    assert _rel(l_c, l_g) < 1e-4


def test_euler_arms_on_the_card_match_the_cpu(cuda):
    """From one init and the same x_init and noise (drawn once on the CPU):
    the aircraft Euler chain (PlaneNet dim 64 / 2 layers, head scaled by
    0.1, ProjectedGaussianDiffusion T = 20, B 4 x 32 points, Haar-Euler
    x_init) within 1e-3 of 1 + the state's largest entry; each step of a
    protein Euler DDPM (ProtNet dim 64, se3=False, every flag, head scaled
    by 0.1, ProjectedEulerDiffusion T = 20, 4 pairs) taken from the CPU
    chain's state, within 1e-4 of it.  The protein chain itself is not held:
    an unclipped Euler chain of an untrained model grows by 1/sqrt(alpha_t)
    a step (to ~1e4 here), its angles reach hundreds of radians, and the two
    devices' sin and cos of those part in the last bits."""
    torch.manual_seed(21)
    model = PlaneNet(dim=64, heads=4, layers=2).eval()
    _scale_head(model.head)
    data = torch.from_numpy(np.random.default_rng(21).standard_normal((4, 32, 3)).astype(np.float32))
    x_init = torch.stack(rmat_to_euler(haar_rotations(torch.Generator().manual_seed(22), (4,))), -1)
    noise = torch.randn(20, 4, 3, generator=torch.Generator().manual_seed(23))
    chains = []
    for dev in ("cpu", cuda):
        with torch.inference_mode():
            chains.append(ProjectedGaussianDiffusion(20, device=dev).p_sample_loop(
                model.to(dev), None, (4, 3), projection=PointCloudProj(data.to(dev), so3=False),
                x_init=x_init.to(dev), noise=noise.to(dev)).cpu())
    assert float((chains[1] - chains[0]).abs().max()) < 1e-3 * (1.0 + float(chains[0].abs().max()))

    torch.manual_seed(24)
    init = ProtNet(dim=64, heads=4, t_depth=2, c_depth=3, se3=False, frame_pool=True, cross_depth=2,
                   rel_frame=True, equiv_head=True).eval()
    _scale_head(init.head_out)
    batch_np = pad_prot_batch([synthetic_prot_pair(np.random.default_rng(24), 40 - i, 20 - i)
                               for i in range(4)])
    proc = ProjectedEulerDiffusion.create(20, device="cpu")
    x = torch.randn(4, 6, generator=torch.Generator().manual_seed(25)) * proc._block_scale()
    noise = torch.randn(20, 4, 6, generator=torch.Generator().manual_seed(26))
    card = (ProjectedEulerDiffusion.create(20, device=cuda), copy.deepcopy(init).to(cuda),
            ProtProjection(to_device(batch_np, cuda), se3=False))
    cpu_proj = ProtProjection(to_device(batch_np, "cpu"), se3=False)
    with torch.inference_mode():
        for j, i in enumerate(range(19, -1, -1)):
            t = torch.full((4,), i)
            nxt = proc.p_sample(init, None, x, t, projection=cpu_proj, noise=noise[j])
            got = card[0].p_sample(card[1], None, x.to(cuda), t.to(cuda), projection=card[2],
                                   noise=noise[j].to(cuda)).cpu()
            assert float((got - nxt).abs().max()) < 1e-4 * (1.0 + float(nxt.abs().max())), i
            x = nxt


@pytest.mark.parametrize("param", ["so3", "euler"])
def test_lock_arm_steps_on_the_card_match_the_cpu(cuda, param):
    """Five lock-arm train steps (batch 32, the same init, t and noise):
    each loss within rtol 1e-4."""
    args = lock.parse_args(["--param", param, "--timesteps", "1000"])
    gen = torch.Generator().manual_seed(27)
    batches = [lock.lock_batch(gen, 32, param) for _ in range(5)]
    ts = [torch.randint(0, args.timesteps, (32,), generator=gen) for _ in range(5)]
    proc_cpu = lock.build(args, "cpu")[1]
    noises = [proc_cpu.sample_noise(gen, t) if param == "so3" else torch.randn(32, 3, generator=gen) for t in ts]
    state0 = lock.build(args, "cpu")[0].state_dict()
    losses = []
    for dev in ("cpu", cuda):
        model, proc = lock.build(args, dev)
        model.load_state_dict(state0)
        losses.append(_train_losses(lock.make_loss_fn(model, proc), model, dev,
                                    [(b.to(dev), t.to(dev), n.to(dev)) for b, t, n in zip(batches, ts, noises)],
                                    skip_nonfinite=True))
    assert _rel(*losses) < 1e-4


def test_jigsaw_images_and_forward_on_the_card_match_the_cpu(cuda):
    """Every pixel of the rendered batch equal; the CoordConv forward within
    1e-4 of the output's scale; at batch 2 and T = 20 the l2 loss at fixed t
    and noise within rtol 1e-4 and a 20-step projected ancestral chain from
    one x_init and noise within 1e-3 of 1 + the state's largest entry."""
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
    gen = torch.Generator().manual_seed(32)
    row = torch.from_numpy(puzzle_rows([31], 128)[0])
    t, noise, x_init = torch.randint(0, 20, (2,), generator=gen), *torch.randn(2, 2, 2, generator=gen)
    chain_noise = torch.randn(20, 2, 2, generator=gen)
    out = []
    for dev in ("cpu", cuda):
        proc = ProjectedGaussianDiffusion(20, loss_type="l2", device=dev)
        with torch.no_grad():
            loss = jigsaw.make_loss_fn(model.to(dev), proc, 2, 128)(None, (row.to(dev), t.to(dev), noise.to(dev)))
            chain = proc.p_sample_loop(model, None, (2, 2), projection=jp, x_init=x_init.to(dev),
                                       noise=chain_noise.to(dev))
        out.append((float(loss), chain.cpu()))
    assert _rel([out[0][0]], [out[1][0]]) < 1e-4
    assert float((out[1][1] - out[0][1]).abs().max()) < 1e-3 * (1.0 + float(out[0][1].abs().max()))


@pytest.mark.parametrize("argv,n", [
    (["--batch", "8", "--timesteps", "100"], 2),
    (["--batch", "256", "--size", "128", "--timesteps", "1000"], 10)], ids=["8", "256"])
def test_jigsaw_driver_resumes_to_the_bit_on_the_card(tmp_path, cuda, argv, n):
    """2N steps against N + save + restore + N through ``jigsaw.main``,
    whose convolutions take cuDNN's deterministic algorithms, small and at
    full width: the weights, Adam's moments and the generator's state to
    the bit."""
    base = argv + ["--print-every", str(10 * n)]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    jigsaw.main(base + ["--steps", str(2 * n), "--ckpt", a])
    jigsaw.main(base + ["--steps", str(n), "--ckpt", b])
    jigsaw.main(base + ["--steps", str(2 * n), "--ckpt", b, "--resume"])
    ra, rb = (torch.load(f"{d}/step_{2 * n:08d}.pt", weights_only=True) for d in (a, b))
    for tree in ("params", "mu", "nu"):
        want = rb["params"] if tree == "params" else rb["opt_state"][tree]
        for k, v in (ra["params"] if tree == "params" else ra["opt_state"][tree]).items():
            assert torch.equal(v, want[k]), (tree, k)
    assert torch.equal(ra["generator_state"], rb["generator_state"])
    assert not torch.backends.cudnn.deterministic  # jigsaw.train restores the flag


@pytest.mark.parametrize("mean", [False, True], ids=["identity-mean", "random-mean"])
def test_igso3xr3_log_prob_on_the_card_launches_kernel_1(cuda, mean):
    """50,000 poses: one launch, log_prob and its rotation part inside the
    kernel's log f gates against the CPU's."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    eps = torch.rand(50_000, generator=gen, device=cuda) + 0.05
    loc = AffineT(exp_skewvec(torch.randn(50_000, 3, generator=gen, device=cuda)),
                  torch.randn(50_000, 3, generator=gen, device=cuda)) if mean else None
    dist = IGSO3xR3.create(eps, mean=loc, shift_scale=75.0, device=cuda)
    value = dist.sample(gen)
    before = obs.counter("ops.igso3.launches")
    lp = dist.log_prob(value)
    torch.cuda.synchronize()
    assert obs.counter("ops.igso3.launches") == before + 1
    cpu = IGSO3xR3.create(eps.cpu(), mean=loc and AffineT(loc.rot.cpu(), loc.shift.cpu()), shift_scale=75.0,
                          device="cpu")
    ref = cpu.log_prob(AffineT(value.rot.cpu(), value.shift.cpu()))
    torch.testing.assert_close(lp.cpu(), ref, **LOGF)
    torch.testing.assert_close(dist.igso3.log_prob(value.rot).cpu(), cpu.igso3.log_prob(value.rot.cpu()),
                               **LOGF)


def test_diagnostics_compute_on_the_card(tmp_path, cuda):
    """se3-path (14 poses, 50 steps) on SO(3) with finite shifts; grad_check
    at 800 iterations and lr 0.05 halves its loss."""
    rots, shifts = diagnostics.main(["se3-path", "--steps", "50", "--out-dir", str(tmp_path)])
    r = torch.from_numpy(rots)
    assert rots.shape == (51, 14, 3, 3) and np.isfinite(shifts).all()
    assert float((r.transpose(-1, -2) @ r - torch.eye(3)).abs().max()) < 1e-4
    res = grad_check.main(["--iters", "800", "--lr", "0.05"])
    assert res["loss_last"] < 0.5 * res["loss_first"]


# -- the scale-out slice --
def test_moe_planenet_on_the_card_matches_the_cpu(cuda):
    """A small MoE PlaneNet (dim 64, 2 layers of 4 experts, B 4 x N 32;
    both dispatches): forward within 1e-5 of its scale, the same
    load-balance loss within rtol 1e-5, the aircraft loss with it within
    rtol 1e-4, and the same expert for every token whose two top
    probabilities lie 1e-6 or more apart."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 32, 3)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 100, 4))
    noise = ProjectedSO3Diffusion(100, device="cpu").sample_noise(torch.Generator().manual_seed(22), t)
    for dispatch in ("scatter", "onehot"):
        torch.manual_seed(0)
        model = PlaneNet(dim=64, heads=4, layers=2, moe_experts=4, moe_dispatch=dispatch)
        routes = []
        for layer in model.encoder.layers:
            def recorded(tokens, *a, route=layer.moe.route, **kw):
                out = route(tokens, *a, **kw)
                routes.append((out[0].detach().float().cpu(), out[2].cpu()))
                return out

            layer.moe.route = recorded
        res = []
        for dev in ("cpu", cuda):
            del routes[:]
            with torch.no_grad():
                fwd, aux = model.to(dev)(x.to(dev), t.to(dev)).cpu(), float(model.moe_aux())
                loss = aircraft.make_loss_fn(model, ProjectedSO3Diffusion(100, device=dev))(
                    None, (x.to(dev), t.to(dev), noise.to(dev)))
            res.append((fwd, aux, float(loss), routes[:2]))
        (ref, ref_aux, ref_loss, ref_routes), (got, aux, loss, got_routes) = res
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
        np.testing.assert_allclose(aux, ref_aux, rtol=1e-5)
        assert _rel([ref_loss], [loss]) < 1e-4
        for (probs, e_cpu), (_, e_card) in zip(ref_routes, got_routes):
            top2 = probs.topk(2, dim=-1).values
            assert not ((e_cpu != e_card) & (top2[:, 0] - top2[:, 1] >= 1e-6)).any()


def test_moe_step_replays_to_the_bits_of_eager_steps(cuda):
    """Eight MoE aircraft steps (dim 64, scatter dispatch, bf16) replayed
    from a CUDA graph give the weights of eight eager steps."""
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
    steps, and the device counters count every replayed step; the
    attention cores and the row passes ran as kernels, eagerly and at the
    capture (the attention kernels use no atomics)."""
    from dataclasses import replace

    from diffusion_extensions_tpu_torch.models.deepseek_v2 import DEEPSEEK_V2_LITE

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
    # the attention cores too: 3 a layer and step (1 forward, 2 backward)
    assert rows[0]["ops.mla_attention.launches"] == 8 * 3 * 3
    assert rows[1]["ops.mla_attention.launches"] == 2 * 3 * 3


@pytest.mark.parametrize("argv,steps,k,clouds", [
    (["--dim", "64", "--layers", "2", "--timesteps", "100"], 8, 4, (8, 32)),
    (["--bf16"], 16, 8, (32, 256))], ids=["dim64", "full-width-bf16"])
def test_nccl_world_of_one_replays_its_all_reduce(cuda, argv, steps, k, clouds):
    """A NCCL group of one made in this process: replayed steps through the
    all-reduce, the loss drawing the global batch's noise and taking the
    rank's slice, give the weights and losses of the steps without a
    group, and the all-reduce was issued while the step was captured."""
    import torch.distributed as dist

    args = aircraft.parse_args(["--so3", *argv])
    batches = torch.randn(steps, *clouds, 3, generator=torch.Generator().manual_seed(0)).to(cuda)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    capturing, all_reduce = [], dist.all_reduce

    def recorded(*a, **kw):
        capturing.append(torch.cuda.is_current_stream_capturing())
        return all_reduce(*a, **kw)

    try:
        dist.all_reduce = recorded
        weights, losses = [], []
        for group in (None, dist.group.WORLD):
            model, process = aircraft.build(args, cuda)
            opt = make_optimizer(model.named_parameters(), 1e-3)
            loss_fn = (aircraft.make_loss_fn(model, process) if group is None
                       else aircraft.make_global_loss_fn(model, process, group))
            step = make_dp_train_step(loss_fn, model, opt, steps_per_call=k, group=group)
            state = TrainState(model, opt, torch.Generator(device=cuda).manual_seed(1))
            for i in range(0, steps, k):
                state, m = step(state, batches[i:i + k])
                losses.append(float(m["loss"]))
            weights.append(model.state_dict())
    finally:
        dist.all_reduce = all_reduce
        dist.destroy_process_group()
    assert sum(capturing) == 1
    assert losses[:steps // k] == losses[steps // k:]
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


@functools.lru_cache
def _config_leaves(name):
    """The parameter shapes of a benchmark configuration's model (built on
    the meta device)."""
    with torch.device("meta"):
        model = PlaneNet(dim=512, heads=4, layers=4) if name == "planenet-d512" else ProtNet(
            dim=1024, heads=8, t_depth=12, c_depth=8, frame_pool=True, cross_depth=2, rel_frame=True,
            equiv_head=True, bf16=True)
    return {f"w{i}": p.shape for i, p in enumerate(model.parameters())}


def _adam_params(cuda, seed, leaves="edge"):
    """ADAM_LEAVES' parameters, or a benchmark configuration's drawn on the card."""
    if leaves != "edge":
        gen = torch.Generator(device=cuda).manual_seed(seed)
        return [(n, torch.nn.Parameter(torch.randn(s, generator=gen, device=cuda) * 0.02))
                for n, s in _config_leaves(leaves).items()]
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


def _adam_grads(cuda, step, leaves="edge"):
    """Step ``step``'s gradients: their norm crosses 1 both ways over the
    sequence (every third step is 100x smaller), so a clip at 1.0 both
    scales and leaves alone."""
    scale = 1e-4 if step % 3 == 0 else 1e-2
    if leaves != "edge":
        gen = torch.Generator(device=cuda).manual_seed(500 + step)
        return {n: torch.randn(s, generator=gen, device=cuda) * scale for n, s in _config_leaves(leaves).items()}
    rng = np.random.default_rng(500 + step)
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
    with monkeypatch.context() as m:
        m.setattr(optim, "adam_update", adam_cuda.adam_update_ref)
        opt.step()


ADAM_CASES = [
    pytest.param("edge", impl, clip, schedule, dtype, id=f"{impl}-{dtype}-clip{clip}-{schedule}")
    for impl, dtype in (("optax", "f32"), ("fused", "f32"), ("fused", "bf16"))
    for clip in (0.0, 1.0) for schedule in ("const", "cosine")] + [
    pytest.param("planenet-d512", "optax", 0.0, "const", "f32", id="planenet-d512"),
    pytest.param("protnet-d1024-prod", "fused", 0.0, "const", "bf16", id="protnet-d1024-prod")]


@pytest.mark.parametrize("leaves,impl,clip,schedule,state_dtype", ADAM_CASES)
def test_adam_kernel_matches_plain_version(cuda, monkeypatch, leaves, impl, clip, schedule, state_dtype):
    """Every implementation, moment dtype, clip and schedule the factory
    takes on ADAM_LEAVES, and the leaf sets of the benchmark's two
    configurations at their implementation and moment dtype: 20 steps of
    the kernel against 20 of the plain version on the card from the same
    weights and gradients.  The kernel rounds each
    operation as the plain version's PyTorch kernel does on the card (an
    explicit round-to-nearest intrinsic each, the fused order's two moment
    updates as PyTorch's one fused multiply-add each, bf16 moments rounded
    to nearest even at the store), so weights and moments agree to the bit
    after every step; one launch a step."""
    kw = dict(clip=clip, schedule=schedule, total_steps=ADAM_STEPS // 2, impl=impl,
              state_dtype=state_dtype)
    mine, ref = _adam_params(cuda, 1, leaves), _adam_params(cuda, 1, leaves)
    kernel, plain = make_optimizer(mine, 1e-2, **kw), make_optimizer(ref, 1e-2, **kw)
    for step in range(ADAM_STEPS):
        grads = _adam_grads(cuda, step, leaves)
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
    if leaves != "edge":
        return
    moved = {n: float((p.detach() - q.detach()).abs().max())
             for (n, p), (_, q) in zip(mine, _adam_params(cuda, 1)) if p.numel()}
    assert all(moved[n] > 0 for n in ("one", "three", "big", "offset", "tiny"))
    assert moved["zeros"] == 0.0


def test_adam_kernel_splits_a_table_of_many_leaves(cuda, monkeypatch):
    """More leaves than one launch's table holds (``MAX_LEAVES``): two
    launches, the same bits as the plain version."""
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
            adam_cuda.adam_update(p, g, m, v, one, one, one, None, impl="optax", b1=0.9, b2=0.999,
                        eps=1e-8, clip=0.0)
    assert obs.counter("ops.adam.launches") == before


# The experts layer's row passes (ops/moe_rows_cuda.py) at the
# dsv2lite-aircraft-train cell's shapes: T 16,384 tokens, top 6 of 64
# experts, 8 held, d 2,048, f 1,408; ``bias`` lowers the held experts'
# scores so that about 10,330 of the T k = 98,304 rows are held, as the
# cell's untrained router holds them.  MOE_KIMI: the
# kimilinear-aircraft-train cell's, top 8 (MAX_K) of 256 experts, 8 held,
# d 2,304, f 1,024, about 2,300 of the 131,072 rows held (the cell's held
# share, ~0.56 of the even 4,096).
MOE_CELL = dict(t=16_384, k=6, e=64, held=8, d=2048, f=1408, bias=-0.105)
MOE_KIMI = dict(t=16_384, k=8, e=256, held=8, d=2304, f=1024, bias=-0.25)


def _moe_plan(cuda, case, seed=0, c=MOE_CELL):
    """(order, inv, offs, held_mask (T, k)) of a routing drawn on the card
    at the shapes ``c``: ``"cell"`` the cell's share of the choices held,
    token 0 holding all its k choices and token 1 none; ``"none"`` no
    choice held (n = 0); ``"all"`` every expert held (n = T k, as with
    experts_held = n_routed_experts)."""
    t, k, e = c["t"], c["k"], c["e"]
    held = e if case == "all" else c["held"]
    gen = torch.Generator(device=cuda).manual_seed(seed)
    scores = torch.randn(t, e, generator=gen, device=cuda)
    if case == "cell":
        scores[:, :held] += c["bias"]
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


def _moe_operands(cuda, case, seed=0, dtype=torch.bfloat16, c=MOE_CELL, **shapes):
    """The routing at the shapes ``c`` (with ``shapes`` in place of its
    own), its n, and every pass's inputs and incoming gradients, rows past
    n filled with NaN."""
    c = dict(c, **shapes)
    t, k, d, f = c["t"], c["k"], c["d"], c["f"]
    order, inv, offs, mine = _moe_plan(cuda, case, seed, c)
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


@pytest.mark.parametrize("case", ["cell", "none", "all", "kimi_cell", "kimi_all"])
def test_moe_rows_kernels_match_plain_versions(cuda, case):
    """Each kernel, forward and backward, against its plain version on the
    card at a cell's shapes (``kimi_``: MOE_KIMI's), rows past n NaN in
    every input: the rows
    under n and the per-token results equal the plain version's to the bit
    (each rounds as PyTorch's kernels do, a token's k rows summed in the
    order of PyTorch's reduction), all finite.  The combine's gradient of
    the weights is a float32 dot product over d summed in another order
    than PyTorch's: within 2 d 2^-24 sum |g y| of it, the bound of two
    orders' rounding; 0 where a choice is not held.  Six launches."""
    trunk, _, case = case.rpartition("_")
    ops = _moe_operands(cuda, case, c=MOE_KIMI if trunk == "kimi" else MOE_CELL)
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
    assert torch.isfinite(got["w"]).all()
    assert ((got["w"] - want["w"]).abs() <= mr.grad_w_atol(ops["grad_out"], ops["ys"], inv, mine)).all()
    assert not got["w"][~mine].any()


def test_moe_rows_kernels_touch_no_row_past_n(cuda):
    """Each launch into outputs filled with NaN: the rows past n keep their
    NaN bits (never written), the rows under n and every per-token output
    are written and finite, though every input row past n is NaN (never
    read)."""
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


# -- the Kimi Linear trunk (models/kimi_linear.py) --
def _kimi_small():
    """A small Kimi Linear trunk on the kernels' small MLA heads (4 of 32 +
    16, v 32): d 256, KDA 4 heads of 32, 16 experts top 8 (kernel 4's
    MAX_K), 8 held, the published layers 1-5, chunks of 64."""
    from dataclasses import replace

    from diffusion_extensions_tpu_torch.models.kimi_linear import KIMI_LINEAR_48B

    return replace(KIMI_LINEAR_48B, hidden_size=256, intermediate_size=512, moe_intermediate_size=128,
                   num_experts=16, num_experts_per_token=8, num_attention_heads=4, kv_lora_rank=64,
                   qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32, linear_attn_num_heads=4,
                   linear_attn_head_dim=32, num_hidden_layers=5, experts_held=8)


def test_kda_chunks_on_the_card_follow_the_recurrence(cuda):
    """The chunked recurrence in float32 on the card at the cell's head
    dims (dk = dv = 128), 3 chunks and a ragged end, decays from e^-20 to
    ~1 a point: output and input gradients within 1e-4 of the float64
    token recurrence's scale (on the CPU)."""
    from benchmark.reference.kimi_linear import recurrent_kda
    from diffusion_extensions_tpu_torch.models.kimi_linear import chunk_kda

    gen = torch.Generator().manual_seed(0)
    b, h, n, d = 2, 4, 170, 128
    q = torch.nn.functional.normalize(torch.randn(b, h, n, d, generator=gen, dtype=torch.float64), dim=-1) * d ** -0.5
    k = torch.nn.functional.normalize(torch.randn(b, h, n, d, generator=gen, dtype=torch.float64), dim=-1)
    v = torch.randn(b, h, n, d, generator=gen, dtype=torch.float64)
    g = -torch.exp(torch.randn(b, h, n, d, generator=gen, dtype=torch.float64) * 2 - 1)
    beta = torch.rand(b, h, n, generator=gen, dtype=torch.float64)
    w = torch.randn(b, h, n, d, generator=gen, dtype=torch.float64)
    xs = [x.requires_grad_(True) for x in (q, k, v, g, beta)]
    want = recurrent_kda(*xs)
    want_g = torch.autograd.grad((want * w).sum(), xs)
    card = [x.detach().float().to(cuda).requires_grad_(True) for x in xs]
    got = chunk_kda(*card)
    got_g = torch.autograd.grad((got * w.float().to(cuda)).sum(), card)
    for a, r in zip((got, *got_g), (want, *want_g)):
        assert float((a.double().cpu() - r.detach()).abs().max()) <= 1e-4 * float(r.abs().max())


def test_kimi_trunk_on_the_card_matches_the_reference(cuda):
    """The small trunk in bf16 on the card (kernel 5 in MLA, kernel 4 at k
    8, KDA's chunks in float32) against the float64 reference on the same
    weights, batch, t and noise: the loss within 2%, the readout's
    gradients within 5% (median leaf), every gradient finite."""
    import statistics

    from benchmark.harness import weights as wts
    from benchmark.reference import kimi_linear as ref
    from benchmark.reference import processes as ref_proc
    from benchmark.reference.schedule import Schedule

    c = _kimi_small()
    rc = dict(hidden_size=c.hidden_size, num_attention_heads=c.num_attention_heads,
              qk_nope_head_dim=c.qk_nope_head_dim, qk_rope_head_dim=c.qk_rope_head_dim, v_head_dim=c.v_head_dim,
              kv_lora_rank=c.kv_lora_rank, intermediate_size=c.intermediate_size,
              moe_intermediate_size=c.moe_intermediate_size, num_experts=c.num_experts,
              num_experts_per_token=c.num_experts_per_token, num_shared_experts=c.num_shared_experts,
              first_k_dense_replace=c.first_k_dense_replace, num_hidden_layers=c.num_hidden_layers,
              rms_norm_eps=c.rms_norm_eps, routed_scaling_factor=c.routed_scaling_factor,
              experts_held=c.experts_held, bias_update_speed=c.bias_update_speed,
              linear_attn_config=dict(num_heads=c.linear_attn_num_heads, head_dim=c.linear_attn_head_dim,
                                      short_conv_kernel_size=c.short_conv_kernel_size,
                                      kda_layers=list(c.kda_layers), full_attn_layers=list(c.full_attn_layers)))
    w = wts.make(ref.param_spec(rc), 7, torch.device("cpu"))
    model = PlaneNet(trunk=c, bf16=True)
    model.load_state_dict(dict(w, **{k: torch.zeros_like(v) for k, v in model.named_buffers()}), strict=True)
    model = model.to(cuda)
    rng = np.random.default_rng(1)
    clouds = torch.from_numpy(rng.standard_normal((4, 160, 3)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 100, 4))
    noise = ProjectedSO3Diffusion(100, device="cpu").sample_noise(torch.Generator().manual_seed(3), t)
    loss = aircraft.make_loss_fn(model, ProjectedSO3Diffusion(100, device=cuda))(
        None, (clouds.to(cuda), t.to(cuda), noise.to(cuda)))
    loss.backward()
    p = {k: v.double().requires_grad_(True) for k, v in w.items()}
    biases = [torch.zeros(c.num_experts) for _ in range(4)]
    want = ref_proc.so3_loss(lambda x, tt: ref.forward(p, rc, x, tt, biases)[0], clouds.double(), t,
                             noise.double(), Schedule(100, torch.device("cpu")))
    grads = dict(zip(p, torch.autograd.grad(want, list(p.values()))))
    assert abs(float(loss) - float(want)) <= 0.02 * abs(float(want))
    named = dict(model.named_parameters())
    assert all(torch.isfinite(param.grad).all() for param in named.values())
    diffs = [float((named[k].grad.double().cpu() - g).norm() / g.norm()) for k, g in grads.items()
             if k.startswith(("pool.", "head."))]
    assert statistics.median(diffs) <= 0.05, diffs


def test_kimi_trunk_step_replays_to_the_bits_of_eager_steps(cuda, monkeypatch):
    """Eight aircraft steps of PlaneNet with the small Kimi Linear trunk
    (bf16) in calls of K = 2 (the first sub-step eager, then one CUDA graph
    replayed, the correction biases' move inside it) give the weights, the
    biases and the losses of eight eager steps after every call; each bias
    moves once a step, by -1, 0 or +1 times 0.001 an expert, and not all
    by 0; the device counters count every step."""
    monkeypatch.setitem(aircraft.TRUNKS, "small", _kimi_small())
    args = aircraft.parse_args(["--so3", "--timesteps", "100", "--trunk", "small", "--bf16"])
    batches = torch.randn(8, 8, 128, 3, generator=torch.Generator().manual_seed(0)).to(cuda)
    runs = []
    for k in (1, 2):
        obs.reset()
        model, process = aircraft.build(args, cuda)
        opt = make_optimizer(model.named_parameters(), 1e-3, impl="fused")
        step = make_dp_train_step(aircraft.make_loss_fn(model, process), model, opt, steps_per_call=k)
        state = TrainState(model, opt, torch.Generator(device=cuda).manual_seed(1))
        out = []
        for i in range(0, 8, k):
            state, m = step(state, batches[i] if k == 1 else batches[i:i + k])
            out.append((m["loss"].clone(), copy.deepcopy(model.state_dict())))
        runs.append((out, obs.snapshot()["counters"]))
    (eager, c_eager), (replayed, c_replayed) = runs
    for (l1, s1), (l2, s2) in zip(eager[1::2], replayed):
        assert torch.equal(l1, l2)
        for name, w in s1.items():
            assert torch.equal(w, s2[name]), name
    name = "encoder.layers.1.mlp.e_score_correction_bias"
    prev = torch.zeros(16, device=cuda)
    for _, s in eager:
        moves = (s[name] - prev) / 1e-3
        assert float((moves - moves.round()).abs().max()) < 1e-3 and float(moves.round().abs().max()) <= 1
        prev = s[name]
    assert float(prev.abs().max()) > 0
    assert c_eager["moe.layer_steps"] == c_replayed["moe.layer_steps"] == 8 * 4
    assert c_eager["moe.rows_even"] == c_replayed["moe.rows_even"] == 8 * 4 * 8 * 128 * 8 * 8 // 16
    assert c_replayed["kda.captures"] == 4 and c_replayed["kda.graph_kernels"] > 0


# MLA's attention core (ops/mla_attention_cuda.py, kernel 5) at the
# dsv2lite-aircraft-train cell's heads (16 of 128 + 64, v 128), the
# kimilinear-aircraft-train cell's (16 clouds of 1,024 points, 32 heads,
# its softmax scale 192^-1/2) and the small trunk's (4 of 32 + 16, v 32):
# clouds, points, heads, (qk, rope, v); the ragged N = 200 and N = 1
# leave a key and a query tile part-filled
MLA_CASES = {"cell": (64, 256, 16, 192, 64, 128), "cell_n32": (8, 32, 16, 192, 64, 128),
             "cell_n200": (8, 200, 16, 192, 64, 128), "small_n256": (4, 256, 4, 48, 16, 32),
             "small": (8, 32, 4, 48, 16, 32), "small_n200": (4, 200, 4, 48, 16, 32), "small_n1": (2, 1, 4, 48, 16, 32),
             "kimi": (16, 1024, 32, 192, 64, 128)}
MLA_RANK = 512  # the rope slice starts here in kv_a_proj_with_mqa's rows


def _mla_operands(cuda, dims, seed=0, kimi=False):
    """Unit-normal bf16 rows as the projections write them, dO, and the
    softmax scale (DeepSeek-V2-Lite's, or with ``kimi`` Kimi Linear's)."""
    from diffusion_extensions_tpu_torch.models.deepseek_v2 import DEEPSEEK_V2_LITE
    from diffusion_extensions_tpu_torch.models.kimi_linear import KIMI_LINEAR_48B

    b, n, h, dqk, dr, dv = dims
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=cuda).bfloat16()

    scale = (KIMI_LINEAR_48B.deepseek() if kimi else DEEPSEEK_V2_LITE).softmax_scale
    return dict(dims=dims, q=rnd(b, n, h * dqk), kv=rnd(b, n, h * (dqk - dr + dv)), kpe=rnd(b, n, MLA_RANK + dr),
                grad=rnd(b, n, h, dv), scale=scale)


def _mla_views(ops, dtype=torch.bfloat16, grad=True):
    """q (B, N, H, qk) and kv (B, N, H, nope + v) viewed from their rows,
    k_pe the rope slice: the strides ``MLA`` hands over."""
    b, n, h, dqk, dr, dv = ops["dims"]
    views = (ops["q"].to(dtype).view(b, n, h, dqk), ops["kv"].to(dtype).view(b, n, h, -1),
             ops["kpe"].to(dtype)[..., MLA_RANK:])
    return tuple(x.requires_grad_(grad) for x in views)


def _mla_run(fn, ops, dtype=torch.bfloat16):
    q, kv, k_pe = _mla_views(ops, dtype)
    o = fn(q, kv, k_pe, ops["scale"])
    dq, dkv, dk_pe = torch.autograd.grad(o, [q, kv, k_pe], ops["grad"].to(dtype))
    return {"o": o.detach(), "dq": dq, "dkv": dkv, "dk_pe": dk_pe}


@pytest.mark.parametrize("case", list(MLA_CASES))
def test_mla_attention_kernels_match_plain_version(cuda, case):
    """Forward and backward through the wrapper against the plain version on
    the card (autograd, same bf16 inputs): every output within its gate
    (``mla_attention_cuda.GATES``), finite, in the inputs' shapes and dtype,
    and, past one point, no further from a float64 evaluation than the
    plain version is (norm of the difference; the kernels keep the logits
    in float32).  Three launches."""
    ops = _mla_operands(cuda, MLA_CASES[case], kimi=case == "kimi")
    before = obs.counter("ops.mla_attention.launches")
    got = _mla_run(mla.attention, ops)
    torch.cuda.synchronize()
    assert obs.counter("ops.mla_attention.launches") == before + 3
    want = _mla_run(mla.attention_ref, ops)
    exact = _mla_run(mla.attention_ref, ops, torch.float64)
    for key, (rtol, atol) in mla.GATES.items():
        a, b, e = got[key], want[key], exact[key]
        assert a.dtype == torch.bfloat16 and a.shape == b.shape, key
        assert torch.isfinite(a).all(), key
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol, atol=atol, msg=key)
        # with one point the softmax's gradient is 0: the plain version
        # subtracts equal numbers, the kernels D and dP summed in two orders
        if ops["dims"][1] > 1:
            err = float(torch.linalg.vector_norm(a.double() - e))
            assert err <= float(torch.linalg.vector_norm(b.double() - e)), key


def test_mla_attention_kernels_repeat_their_bits(cuda):
    """Two calls, forward and backward, give the same bits: every sum in a
    fixed order (dq over key tiles, dk_pe over heads), no atomics."""
    ops = _mla_operands(cuda, MLA_CASES["cell"], seed=1)
    first, second = _mla_run(mla.attention, ops), _mla_run(mla.attention, ops)
    for key in first:
        assert torch.equal(first[key], second[key]), key


def test_mla_attention_kernels_write_every_output(cuda):
    """Launched into outputs filled with NaN (N = 200: a ragged key and
    query tile), every element of o, the log-sum-exp, D, dq, dkv and
    dk_pe comes back written and finite."""
    from diffusion_extensions_tpu_torch.models.deepseek_v2 import DEEPSEEK_V2_LITE

    ops = _mla_operands(cuda, MLA_CASES["cell_n200"], seed=2)
    b, n, h, dqk, dr, dv = ops["dims"]
    q, kv, k_pe = _mla_views(ops, grad=False)

    def nans(*shape, dt=torch.bfloat16):
        return torch.full(shape, float("nan"), device=cuda, dtype=dt)

    o, lse, delta = nans(b, n, h, dv), nans(b, h, n, dt=torch.float32), nans(b, h, n, dt=torch.float32)
    dq, dkv, dk_pe = nans(b, n, h, dqk), nans(b, n, h, dqk - dr + dv), nans(b, n, dr)
    scale = DEEPSEEK_V2_LITE.softmax_scale
    mla.launch_forward(q, kv, k_pe, scale, o, lse)
    mla.launch_backward(q, kv, k_pe, scale, o, lse, ops["grad"], delta, dq, dkv, dk_pe)
    torch.cuda.synchronize()
    for name, x in (("o", o), ("lse", lse), ("delta", delta), ("dq", dq), ("dkv", dkv), ("dk_pe", dk_pe)):
        assert torch.isfinite(x).all(), name


def test_mla_attention_refuses_what_the_kernels_cannot_take(cuda):
    """float32 operands on the card (the trunk without --bf16) and head dims
    the kernels are not built for raise, naming --bf16 and the built dims;
    nothing is launched."""
    before = obs.counter("ops.mla_attention.launches")
    ops = _mla_operands(cuda, MLA_CASES["small"])
    with pytest.raises(TypeError, match="--bf16"):
        mla.attention(*_mla_views(ops, torch.float32, grad=False), 0.1)
    q, kv, k_pe = _mla_views(ops, grad=False)
    with pytest.raises(ValueError, match="48, 16, 32"):
        mla.attention(q[..., :32], kv, k_pe[..., :8], 0.1)
    assert obs.counter("ops.mla_attention.launches") == before
