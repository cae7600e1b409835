#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from the sources in this checkout (one
nvcc per source, all started together), holds each against its plain
PyTorch version on the card, then drives two paths at full size, each with
the kernels' launch counts set to 0 just before it and read just after:

* the aircraft sampling path (PlaneNet dim 512 / 4 heads / 4 layers, random
  weights from a seed, batch 32 x 256 points, ProjectedSO3Diffusion with
  T = 1000): the 1000-step ancestral chain, the 50-step Heun
  probability-flow sampler (whose score runs the IGSO(3) kernel) and
  IsotropicGaussianSO3.log_prob on 50,000 rotations;
* the Bingham evaluation path, ``experiments/bingham.py --test --sampler-ab``
  on the "lcr" preset: RotPredict d_model 65 (seeded init), SO3Diffusion
  T = 1000, 20,000 chains per sampler row, and MMD against 20,000 target
  rotations, whose three 20k x 20k sums run the MMD kernel.

Every phase prints JSON lines, and the seconds each phase took; any failure
raises and exits non-zero.  The last lines are the kernels' summary, the
card's name and power limit as nvidia-smi reports them, and
{"ok": true, "device": {...}}.

Imports torch, numpy and the port only.  There is no CPU path: without a
CUDA device the script exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from diffusion_extensions_tpu_torch.data.shapenet import synthetic_planes
from diffusion_extensions_tpu_torch.data.synthetic import bingham_dist
from diffusion_extensions_tpu_torch.experiments import bingham
from diffusion_extensions_tpu_torch.experiments.aircraft import subsample_points
from diffusion_extensions_tpu_torch.models.planenet import PlaneNet
from diffusion_extensions_tpu_torch.models.projections import PointCloudProj
from diffusion_extensions_tpu_torch.models.rot_predict import RotPredict
from diffusion_extensions_tpu_torch.ops import igso3_cuda, mmd_cuda
from diffusion_extensions_tpu_torch.ops.igso3 import IsotropicGaussianSO3, igso3_log_density
from diffusion_extensions_tpu_torch.ops.metrics import mmd
from diffusion_extensions_tpu_torch.ops.so3 import exp_skewvec, quat_to_rmat, rotation_angle
from diffusion_extensions_tpu_torch.processes.so3 import ProjectedSO3Diffusion, SO3Diffusion

# H100 SXM data-sheet peaks (dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# IGSO(3) kernel, per element: two f32 loads + two f32 stores, and ~90 f32
# operations counting each exp/log/sin/tan/sinh/cosh as one
IGSO3_BYTES, IGSO3_OPS = 16, 90
# MMD kernel: 36 bytes a rotation read once, 4 bytes out; per pair 67 f32
# operations, what the kernel body executes: the four bilinears' 27 FMA (the
# trace 9, each skew component 6) count 54; sx^2 + sy^2 + sz^2 5, sqrt 1, its
# 0.5 scale 1, c = 0.5 (tr - 1) 2, atan2 1, the -sqrt(2) scale 1, exp 1 and
# the accumulate 1
MMD_BYTES_PER_ROT, MMD_OPS_PER_PAIR = 36, 67
# gates of tests/test_pallas.py
LOGF_TOL = (1e-5, 1e-5)  # rtol, atol
SCORE_TOL = (1e-4, 5e-4)
MMD_SUM_RTOL = 1e-4
MMD_TOL = (1e-3, 1e-5)
PATH = dict(dim=512, heads=4, layers=4, batch=32, samples=256, timesteps=1000,
            heun_steps=50, log_prob_n=50_000)
BINGHAM_COV, BINGHAM_N = "lcr", 20_000
# Bingham rows: kernel launches each row must make (3 MMD sums per row)
BINGHAM_IGSO3 = {"ancestral_1000": 0, "ddim_50": 0, "ddim_20": 0, "pf_flow_50": 0,
                 "pf_flow_10": 0, "pf_heun_25_karras": 50, "pf_euler_50_karras": 50,
                 "ddim_50_picard": 0}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def time_cuda(fn, iters: int, warmup: int = 10) -> float:
    """Mean ms per call over ``iters`` calls, by CUDA events after warm-up."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / iters


def time_graph(fn, reps: int = 100, replays: int = 10) -> float:
    """Device ms per call: ``reps`` calls captured in one CUDA graph and
    replayed, so the host's launch cost drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    sync()
    return start.elapsed_time(end) / (replays * reps)


def igso3_bound_ms(n: int) -> tuple[float, str]:
    t_bytes = IGSO3_BYTES * n / HBM_BYTES_PER_S
    t_ops = IGSO3_OPS * n / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def mmd_bound_ms(n: int, m: int) -> tuple[float, str]:
    t_bytes = (MMD_BYTES_PER_ROT * (n + m) + 4) / HBM_BYTES_PER_S
    t_ops = MMD_OPS_PER_PAIR * n * m / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def planenet_flops(dim: int, layers: int, batch: int, points: int, dff: int = 2048) -> float:
    """Matmul FLOPs of one PlaneNet forward: Siren, per layer q/k/v/out and
    the feed-forward pair plus QK^T and AV, then the pooling head."""
    half = dim // 2
    per_token = 2 * (3 * half + half * half) + 2 * (dim + dim * dim)
    per_token += layers * (2 * (4 * dim * dim + 2 * dim * dff) + 4 * points * dim)
    return float(per_token * batch * points)


def kernel_inputs(n: int, seed: int):
    """t uniform on (0, pi) with t = 0, t in (0, 1e-6), t in (1e-6, 1e-4)
    and t near pi; sigma uniform on [0.02, 1.5] with sigma = 1e-3 entries."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(0.0, np.pi, n).astype(np.float32)
    s = rng.uniform(0.02, 1.5, n).astype(np.float32)
    k = min(n, 6)
    t[:k] = np.array([0.0, 3e-7, 5e-6, 5e-5, np.pi - 1e-4, np.pi], np.float32)[:k]
    s[6:9] = 1e-3
    return torch.from_numpy(t).cuda(), torch.from_numpy(s).cuda()


def gate(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float):
    """(max |got - want|, max |got - want| / (atol + rtol |want|))."""
    diff = (got - want).abs()
    return float(diff.max()), float((diff / (atol + rtol * want.abs())).max())


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs on an NVIDIA GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         capability=list(torch.cuda.get_device_capability(0)), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0])
    return smi


def phase_build() -> None:
    """Both kernels' nvcc builds, started together."""
    kernels = {"igso3_logpdf_score": igso3_cuda, "gaussian_kernel_sum": mmd_cuda}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:
        futures = {name: pool.submit(mod.build) for name, mod in kernels.items()}
        for fut in futures.values():
            fut.result()
    for name, mod in kernels.items():
        ptxas = [ln.strip() for ln in mod.build_log.splitlines() if "ptxas" in ln]
        emit("build", kernel=name, seconds=time.perf_counter() - t0, ptxas=ptxas)


def phase_kernel_check() -> dict:
    """The kernel against its plain version on the card, then timings."""
    cases = {}
    for n in (PATH["batch"], BINGHAM_N, 1000, 2**20 + 37):
        cases[str(n)] = kernel_inputs(n, seed=n)
    t7 = torch.linspace(0.1, 3.0, 7, device="cuda").reshape(7, 1)
    cases["(7,1)x(1,)"] = (t7, torch.tensor([0.5], device="cuda"))
    worst = {"logf_abs": 0.0, "logf_gate": 0.0, "score_abs": 0.0, "score_gate": 0.0}
    for name, (t, s) in cases.items():
        logf, score = igso3_cuda.igso3_logpdf_score(t, s)
        ref_logf, ref_score = igso3_cuda.igso3_logpdf_score_ref(t, s)
        sync()
        assert logf.shape == ref_logf.shape and score.shape == ref_score.shape, name
        assert torch.isfinite(logf).all() and torch.isfinite(score).all(), name
        la, lg = gate(logf, ref_logf, *LOGF_TOL)
        sa, sg = gate(score, ref_score, *SCORE_TOL)
        emit("kernel_check", kernel="igso3_logpdf_score", case=name,
             logf_max_abs_err=la, logf_gate_ratio=lg, score_max_abs_err=sa,
             score_gate_ratio=sg)
        for k, v in (("logf_abs", la), ("logf_gate", lg), ("score_abs", sa), ("score_gate", sg)):
            worst[k] = max(worst[k], v)
    ok = worst["logf_gate"] <= 1.0 and worst["score_gate"] <= 1.0
    if not ok:
        raise AssertionError(f"igso3_logpdf_score disagrees with its plain version: {worst}")

    # ms / plain_ms: device time per call (CUDA graph replay);
    # call_ms / plain_call_ms: per eager call from Python, what a chain pays
    timing = {}
    for n in (PATH["batch"], BINGHAM_N, 2**20):
        t, s = kernel_inputs(n, seed=1)
        kernel = lambda: igso3_cuda.igso3_logpdf_score(t, s)  # noqa: E731
        plain = lambda: igso3_cuda.igso3_logpdf_score_ref(t, s)  # noqa: E731
        bound_ms, bound_by = igso3_bound_ms(n)
        timing[n] = dict(
            ms=time_graph(kernel), plain_ms=time_graph(plain, reps=20),
            call_ms=time_cuda(kernel, 1000), plain_call_ms=time_cuda(plain, 100),
            bound_ms=bound_ms, bound_by=bound_by,
        )
        emit("kernel_time", kernel="igso3_logpdf_score", n=n, **timing[n])
    return {"worst": worst, "timing": timing, "pass": ok}


def rotations(n: int, seed: int, scale: float = 1.0) -> torch.Tensor:
    v = np.random.default_rng(seed).standard_normal((n, 3)).astype(np.float32) * scale
    return exp_skewvec(torch.from_numpy(v).cuda())


def pi_pairs(n: int, seed: int):
    """X random and Y = X P, with P an exact rotation by pi (2 u u^T - I,
    float64, then cast), so every diagonal pair is at theta = pi."""
    x = rotations(n, seed)
    u = np.random.default_rng(seed + 1).standard_normal((n, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    p = torch.from_numpy(2.0 * u[:, :, None] * u[:, None, :] - np.eye(3)).cuda()
    return x, (x.double() @ p).float()


def plain_mmd(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    def s(a, b):
        return mmd_cuda.gaussian_kernel_sum_ref(a, b, chunksize=4000)

    n, m = x.shape[0], y.shape[0]
    return s(x, x) / n**2 + s(y, y) / m**2 - 2.0 * s(x, y) / (n * m)


def phase_mmd_check() -> dict:
    """The MMD kernel against its plain version on the card (rtol 1e-4 on
    each sum), mmd_cuda against the plain MMD (rtol 1e-3, atol 1e-5), two
    calls at 20k x 20k bit-identical, then timings at the path's 20k x 20k."""
    n = BINGHAM_N
    cases = {
        "1x1": (rotations(1, 1), rotations(1, 2)),
        "257x130": (rotations(257, 3), rotations(130, 4)),
        "300x200": (rotations(300, 5), rotations(200, 6, 0.3)),
        "4096x4096": (rotations(4096, 7), rotations(4096, 8, 0.5)),
        f"{n}x{n}": (rotations(n, 9), rotations(n, 10, 0.7)),
        "X=Y 2000": (rotations(2000, 11),) * 2,
        "pi pairs 2000": pi_pairs(2000, 12),
    }
    worst_abs = worst_rel = 0.0
    for name, (x, y) in cases.items():
        got = mmd_cuda.gaussian_kernel_sum(x, y)
        want = mmd_cuda.gaussian_kernel_sum_ref(x, y, chunksize=4000)
        sync()
        abs_err = float((got - want).abs())
        rel_err = abs_err / float(want.abs())
        emit("kernel_check", kernel="gaussian_kernel_sum", case=name, sum=float(got),
             plain_sum=float(want), abs_err=abs_err, rel_err=rel_err, rtol=MMD_SUM_RTOL)
        if not (torch.isfinite(got) and rel_err <= MMD_SUM_RTOL):
            raise AssertionError(f"gaussian_kernel_sum {name}: {float(got)} vs plain "
                                 f"{float(want)} (rel err {rel_err})")
        worst_abs, worst_rel = max(worst_abs, abs_err), max(worst_rel, rel_err)
    for name in ("300x200", f"{n}x{n}"):
        x, y = cases[name]
        got, want = float(mmd_cuda.mmd_cuda(x, y)), float(plain_mmd(x, y))
        emit("kernel_check", kernel="mmd_cuda", case=name, mmd=got, plain_mmd=want,
             abs_err=abs(got - want))
        if not abs(got - want) <= MMD_TOL[1] + MMD_TOL[0] * abs(want):
            raise AssertionError(f"mmd_cuda {name}: {got} vs plain {want}")
    x, y = cases[f"{n}x{n}"]
    first, second = mmd_cuda.gaussian_kernel_sum(x, y), mmd_cuda.gaussian_kernel_sum(x, y)
    same = bool(torch.equal(first, second))
    emit("kernel_check", kernel="gaussian_kernel_sum", case="determinism", bit_identical=same)
    if not same:
        raise AssertionError(f"two calls differ: {float(first)} vs {float(second)}")

    bound_ms, bound_by = mmd_bound_ms(n, n)
    timing = dict(
        n=n, m=n,
        ms=time_cuda(lambda: mmd_cuda.gaussian_kernel_sum(x, y), 20, warmup=3),
        plain_ms=time_cuda(lambda: mmd_cuda.gaussian_kernel_sum_ref(x, y, chunksize=4000), 3,
                           warmup=1),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
    )
    emit("kernel_time", kernel="gaussian_kernel_sum", **timing)
    return {"max_abs_err": worst_abs, "max_rel_err": worst_rel, "timing": timing}


def small_cpu_agreement() -> None:
    """The Heun sampler on the card (kernel) against the same sampler on the
    CPU (plain version), same weights and same x_init, at a small size:
    dim 64, 2 layers, B 4, N 32, T 50, 10 steps; the denoiser's head is
    scaled by 0.1 so the chain is not chaotic.  1e-3 on rotation entries."""
    torch.manual_seed(3)
    model = PlaneNet(dim=64, heads=4, layers=2).eval()
    with torch.no_grad():
        model.head.weight.mul_(0.1)
        model.head.bias.mul_(0.1)
    data = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 32, 3)).astype(np.float32))
    x_init = torch.linalg.qr(torch.randn(4, 3, 3))[0]
    outs = {}
    for dev in ("cpu", "cuda"):
        proc = ProjectedSO3Diffusion(50, device=dev)
        with torch.inference_mode():
            outs[dev] = proc.pf_sample_loop(
                model.to(dev), None, (4,), 10, PointCloudProj(data.to(dev)),
                method="heun", x_init=x_init.to(dev),
            ).cpu()
    err = float((outs["cpu"] - outs["cuda"]).abs().max())
    emit("small_agreement", sampler="pf_heun", max_abs_err=err, tol=1e-3)
    if not err < 1e-3:
        raise AssertionError(f"Heun sampler: card and CPU disagree by {err}")


def small_bingham_agreement() -> None:
    """The Bingham slice on the card against the same on the CPU: RotPredict
    d_model 65 (seeded, head scaled by 0.1), SO3Diffusion T = 50, DDIM-10
    over 256 chains from the same x_init: 1e-3 on rotation entries; the MMD
    of those samples against 256 Bingham targets (kernel on the card, plain
    version on the CPU): rtol 1e-3."""
    torch.manual_seed(5)
    model = RotPredict(65, "skewvec").eval()
    with torch.no_grad():
        model.out.weight.mul_(0.1)
        model.out.bias.mul_(0.1)
    proc_cpu = SO3Diffusion.create(50, device="cpu")
    x_init = proc_cpu.prior_table.sample(torch.Generator().manual_seed(6),
                                         torch.zeros(256, dtype=torch.long))
    z = torch.from_numpy(np.random.default_rng(7).standard_normal((256, 4)).astype(np.float32))
    target = quat_to_rmat(bingham_dist(BINGHAM_COV, device="cpu").from_normal(z))
    outs, mmds = {}, {}
    for dev in ("cpu", "cuda"):
        proc = proc_cpu if dev == "cpu" else SO3Diffusion.create(50, device=dev)
        with torch.inference_mode():
            outs[dev] = proc.ddim_sample_loop(model.to(dev), None, (256,), 10,
                                              x_init=x_init.to(dev))
            mmds[dev] = float(mmd(target.to(dev), outs[dev]))
    err = float((outs["cpu"] - outs["cuda"].cpu()).abs().max())
    mmd_rel = abs(mmds["cuda"] - mmds["cpu"]) / abs(mmds["cpu"])
    emit("small_agreement", sampler="bingham_ddim_10", max_abs_err=err, tol=1e-3,
         mmd_cuda=mmds["cuda"], mmd_cpu=mmds["cpu"], mmd_rel_err=mmd_rel, mmd_rtol=1e-3)
    if not err < 1e-3:
        raise AssertionError(f"Bingham DDIM chain: card and CPU disagree by {err}")
    if not mmd_rel < 1e-3:
        raise AssertionError(f"Bingham MMD: card {mmds['cuda']} vs CPU {mmds['cpu']}")


def check_rotations(name: str, r: torch.Tensor) -> dict:
    assert r.shape == (PATH["batch"], 3, 3), (name, r.shape)
    assert torch.isfinite(r).all(), name
    eye = torch.eye(3, device=r.device)
    orth = float((r.transpose(-1, -2) @ r - eye).abs().max())
    det = float((torch.linalg.det(r).abs() - 1.0).abs().max())
    if not (orth < 1e-4 and det < 1e-4):
        raise AssertionError(f"{name}: |R^T R - I| = {orth}, ||det R| - 1| = {det}")
    return {"orth_err": orth, "det_err": det}


def phase_path() -> dict:
    """The aircraft sampling path at full width; returns each kernel's
    launches in this run."""
    device = torch.device("cuda")
    t0 = time.perf_counter()
    torch.manual_seed(0)
    model = PlaneNet(dim=PATH["dim"], heads=PATH["heads"], layers=PATH["layers"]).to(device).eval()
    process = ProjectedSO3Diffusion(PATH["timesteps"], device=device)
    clouds = subsample_points(synthetic_planes(128, seed=2), PATH["samples"], seed=17)
    proj = PointCloudProj(torch.from_numpy(clouds[: PATH["batch"]]).to(device))
    dist = IsotropicGaussianSO3.create(0.5, device=device)
    sync()
    setup_s = time.perf_counter() - t0
    x_in = proj(torch.eye(3, device=device).expand(PATH["batch"], 3, 3))
    t_in = torch.full((PATH["batch"],), 500, device=device)
    with torch.inference_mode():
        fwd_ms = time_cuda(lambda: model(x_in, t_in), 10, warmup=3)
    flops = planenet_flops(PATH["dim"], PATH["layers"], PATH["batch"], PATH["samples"])
    emit("path_setup", seconds=setup_s, params=sum(p.numel() for p in model.parameters()),
         forward_ms=fwd_ms, forward_gflop=flops / 1e9,
         forward_tflops=flops / fwd_ms / 1e9, **PATH)

    gen = torch.Generator(device=device).manual_seed(1)
    igso3_cuda.launches = mmd_cuda.launches = 0
    runs = {}
    with torch.inference_mode():
        before = igso3_cuda.launches
        t0 = time.perf_counter()
        r_anc = process.p_sample_loop(model, gen, (PATH["batch"],), proj)
        sync()
        runs["ancestral"] = dict(seconds=time.perf_counter() - t0, steps=PATH["timesteps"],
                                 launches=igso3_cuda.launches - before,
                                 **check_rotations("ancestral", r_anc))

        before = igso3_cuda.launches
        t0 = time.perf_counter()
        r_heun = process.pf_sample_loop(model, gen, (PATH["batch"],), PATH["heun_steps"],
                                        proj, method="heun")
        sync()
        runs["pf_heun"] = dict(seconds=time.perf_counter() - t0, steps=PATH["heun_steps"],
                               launches=igso3_cuda.launches - before,
                               **check_rotations("pf_heun", r_heun))

        samples = dist.sample(gen, (PATH["log_prob_n"],))
        sync()
        before = igso3_cuda.launches
        t0 = time.perf_counter()
        lp = dist.log_prob(samples)
        sync()
        runs["log_prob"] = dict(seconds=time.perf_counter() - t0, n=PATH["log_prob_n"],
                                launches=igso3_cuda.launches - before)
    total = {"igso3_logpdf_score": igso3_cuda.launches,
             "gaussian_kernel_sum": mmd_cuda.launches}

    assert lp.shape == (PATH["log_prob_n"],) and torch.isfinite(lp).all()
    ref = igso3_log_density(rotation_angle(samples), dist.eps)
    la, lg = gate(lp, ref, *LOGF_TOL)
    runs["log_prob"].update(max_abs_err_vs_plain=la, gate_ratio=lg)
    for name, run in runs.items():
        emit("path_run", run=name, **run)
    want = {"ancestral": 0, "pf_heun": 2 * PATH["heun_steps"], "log_prob": 1}
    got = {k: runs[k]["launches"] for k in want}
    if got != want:
        raise AssertionError(f"IGSO(3) kernel launches {got}, expected {want}")
    if lg > 1.0:
        raise AssertionError(f"log_prob disagrees with the plain density: {la}")
    if total["igso3_logpdf_score"] == 0:
        raise AssertionError("the aircraft path launched no IGSO(3) kernel")
    return total


def phase_bingham_path() -> dict:
    """experiments/bingham.py --test --sampler-ab at full size, seeded init,
    records into a temporary directory; returns each kernel's launches."""
    if (bingham.SAMPLES, bingham.NET_SAMPLES) != (BINGHAM_N, BINGHAM_N):
        raise AssertionError(f"bingham.SAMPLES = {bingham.SAMPLES}, expected {BINGHAM_N}")
    igso3_cuda.launches = mmd_cuda.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rows = bingham.main([BINGHAM_COV, "--test", "--sampler-ab", "--timesteps", "1000",
                             "--out-dir", tmp, "--ckpt", os.path.join(tmp, "none.pt")])
        seconds = time.perf_counter() - t0
        files = sorted(os.listdir(tmp))
    total = {"igso3_logpdf_score": igso3_cuda.launches,
             "gaussian_kernel_sum": mmd_cuda.launches}
    rows = rows[BINGHAM_COV]
    for r in rows:
        emit("bingham_run", sampler=r["sampler"], seconds=r["sample_seconds"],
             model_evals=r["model_evals"], mmd=r["mmd"], passes=r["passes"],
             accept_threshold=r["accept_threshold"], sweeps=r.get("sweeps"),
             launches=r["launches"], orth_err=r["orth_err"], det_err=r["det_err"],
             count=r["count"])
    emit("bingham_path", seconds=seconds, launches=total, files=files)
    got = {r["sampler"]: r["launches"] for r in rows}
    want = {k: {"igso3_logpdf_score": v, "gaussian_kernel_sum": 3}
            for k, v in BINGHAM_IGSO3.items()}
    if got != want:
        raise AssertionError(f"Bingham path kernel launches {got}, expected {want}")
    for r in rows:
        ok = (r["count"] == BINGHAM_N and np.isfinite(r["mmd"]) and r["orth_err"] < 1e-4
              and r["det_err"] < 1e-4)
        if not ok:
            raise AssertionError(f"Bingham row {r['sampler']}: {r}")
    if rows[0]["model_evals"] != 1000:
        raise AssertionError(f"ancestral row made {rows[0]['model_evals']} model evaluations")
    if files != [f"torch_bingham_mmd_{BINGHAM_COV}.json",
                 f"torch_bingham_sampler_ab_{BINGHAM_COV}.json"]:
        raise AssertionError(f"Bingham records: {files}")
    return total


def timed(name: str, fn):
    t0 = time.perf_counter()
    out = fn()
    emit("phase_seconds", name=name, seconds=time.perf_counter() - t0)
    return out


def main() -> None:
    smi = timed("device", phase_device)
    timed("build", phase_build)
    check = timed("kernel_check_igso3", phase_kernel_check)
    mmd_check = timed("kernel_check_mmd", phase_mmd_check)
    timed("small_agreement_aircraft", small_cpu_agreement)
    timed("small_agreement_bingham", small_bingham_agreement)
    aircraft = timed("aircraft_path", phase_path)
    bing = timed("bingham_path", phase_bingham_path)
    for name, n in bing.items():
        if n == 0:
            raise AssertionError(f"the Bingham path launched no {name} kernel")
    launches = {k: aircraft[k] + bing[k] for k in aircraft}
    main_n = PATH["batch"]
    tm, big = check["timing"][main_n], check["timing"][2**20]
    mid = check["timing"][BINGHAM_N]
    mt = mmd_check["timing"]
    kernels = [{
        "name": "igso3_logpdf_score",
        "route": "cuda",
        "source": "diffusion_extensions_tpu_torch/csrc/igso3_logpdf_score.cu",
        "replaces": "diffusion_extensions_tpu/ops/igso3_pallas.py:101",
        "launches": launches["igso3_logpdf_score"],
        "launches_by_path": {"aircraft": aircraft["igso3_logpdf_score"],
                             "bingham": bing["igso3_logpdf_score"]},
        "max_abs_err": max(check["worst"]["logf_abs"], check["worst"]["score_abs"]),
        "ms": tm["ms"], "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
        "bound_by": tm["bound_by"], "library_ms": None, "n": main_n,
        "call_ms": tm["call_ms"], "plain_call_ms": tm["plain_call_ms"],
        "ms_1m": big["ms"], "plain_ms_1m": big["plain_ms"], "bound_ms_1m": big["bound_ms"],
        "call_ms_1m": big["call_ms"],
        "ms_20k": mid["ms"], "plain_ms_20k": mid["plain_ms"], "bound_ms_20k": mid["bound_ms"],
        "call_ms_20k": mid["call_ms"],
        "logf_max_abs_err": check["worst"]["logf_abs"],
        "score_max_abs_err": check["worst"]["score_abs"],
        "gate_ratio": max(check["worst"]["logf_gate"], check["worst"]["score_gate"]),
        "pass": check["pass"],
    }, {
        "name": "gaussian_kernel_sum",
        "route": "cuda",
        "source": "diffusion_extensions_tpu_torch/csrc/gaussian_kernel_sum.cu",
        "replaces": "diffusion_extensions_tpu/ops/mmd_pallas.py:112",
        "launches": launches["gaussian_kernel_sum"],
        "launches_by_path": {"aircraft": aircraft["gaussian_kernel_sum"],
                             "bingham": bing["gaussian_kernel_sum"]},
        "max_abs_err": mmd_check["max_abs_err"],
        "ms": mt["ms"], "plain_ms": mt["plain_ms"], "bound_ms": mt["bound_ms"],
        "bound_by": mt["bound_by"], "library_ms": None, "n": mt["n"], "m": mt["m"],
        "max_rel_err": mmd_check["max_rel_err"], "pass": True,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
