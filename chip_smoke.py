#!/usr/bin/env python3
"""Kernel timings and full-width runs of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

The port's gates on the card are ``tests/test_torch_cuda.py`` (each kernel
against its plain PyTorch version, at the sizes timed here among others,
and the card against the CPU at small sizes).  This script does what needs
the full width:

* builds every CUDA kernel of the port from the sources in this checkout
  (one nvcc per source, all started together; prints what ptxas says of
  each and, where cuobjdump is there, the SASS instruction counts);
* times each kernel of ``KERNELS`` at its cases, beside its plain version
  and its bound on the H100 (bytes or operations), and measures how far
  its outputs there lie from the plain version's;
* drives each path of ``PATHS`` at full size, with the kernels' launch
  counts set to 0 just before it and read just after, and holds it to the
  gates that need the full width: the kernels the path must launch, a
  falling loss, resumes and replays to the bit, ``--test`` on the written
  checkpoint finite and on SO(3).

The paths: aircraft sampling (PlaneNet dim 512 / 4 heads / 4 layers, batch
32 x 256, T = 1000: the ancestral chain, Heun-50, ``log_prob`` on 50,000
rotations); the Bingham evaluation (``bingham.py --test --sampler-ab``,
20,000 chains a sampler, MMD against 20,000 targets); aircraft training
(timed fp32, bf16, fused-Adam and replayed K = 8 variants, a falling loss,
a resume, 2N steps against N + save + restore + N and against replayed
steps, ``--test``, Heun-50 on the trained weights); Bingham training with
its online MMD curve; protein docking at the headline width (ProtNet dim
1024 / 8 heads / t_depth 12 / c_depth 8 with every flag, 163,077,652
parameters: the forward, then each sampler row of ``--test``) and its
training (timed variants, a falling loss, ``--test``, a replayed resume,
``--epoch-accum``); the Euler arms of both; ``so3_toy``; both ``lock``
arms; ``jigsaw`` at the JAX package's width (timed steps, a falling loss,
cuDNN's determinism and its cost, ``--test``); the diagnostics at their
defaults; the Switch-MoE aircraft arm (bench.py's moe_train_e4, both
dispatches timed); the DeepSeek-V2 and Kimi Linear trunks at their
cells' sizes (replayed steps, then one profiled call); ``--fsdp`` over a
NCCL group of one; ``bench_torch --quick``; a two-point ``sweep``; and
``probe_protein`` on a checkpoint written here.

Every phase prints JSON lines and the seconds it took; any failure raises
and exits non-zero.  The last lines are the kernels' summary (``{"kernels":
[...]}``, each kernel's timings, its distance from the plain version, its
SASS counts and its launches on each path, ``launches_by_path``), the
card's name and power limit as nvidia-smi reports them, and
{"ok": true, "device": {...}}.

Imports torch, numpy and the port only.  There is no CPU path: without a
CUDA device the script exits non-zero before printing any result.
"""
from __future__ import annotations

import contextlib
import hashlib
import io
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch

from diffusion_extensions_tpu_torch import bench, obs, sweep
from diffusion_extensions_tpu_torch.data.jigsaw import puzzle_rows
from diffusion_extensions_tpu_torch.data.pdb import (
    pad_prot_batch,
    synthetic_prot_pair,
    to_device,
)
from diffusion_extensions_tpu_torch.data.shapenet import BatchLoader, synthetic_planes
from diffusion_extensions_tpu_torch.experiments import (
    aircraft,
    bingham,
    diagnostics,
    grad_check,
    jigsaw,
    lock,
    probe_protein,
    protein,
    so3_toy,
)
from diffusion_extensions_tpu_torch.experiments.aircraft import subsample_points
from diffusion_extensions_tpu_torch.flops import planenet_flops, protein_flops
from diffusion_extensions_tpu_torch.models.coordconv import STAGES, WIDTH
from diffusion_extensions_tpu_torch.models.planenet import PlaneNet
from diffusion_extensions_tpu_torch.models.projections import PointCloudProj, ProtProjection
from diffusion_extensions_tpu_torch.models.protnet import ProtNet
from diffusion_extensions_tpu_torch.ops import (_build, adam_cuda, igso3_cuda, mla_attention_cuda, mmd_cuda,
                                                moe_rows_cuda)
from diffusion_extensions_tpu_torch.ops.igso3 import (
    IGSO3xR3,
    IsotropicGaussianSO3,
    igso3_log_density,
)
from diffusion_extensions_tpu_torch.ops.se3 import AffineT
from diffusion_extensions_tpu_torch.ops.so3 import exp_skewvec, rotation_angle
from diffusion_extensions_tpu_torch.parallel.dp import make_dp_train_step
from diffusion_extensions_tpu_torch.processes.so3 import ProjectedSO3Diffusion
from diffusion_extensions_tpu_torch.train.optim import make_optimizer
from diffusion_extensions_tpu_torch.train.state import (
    TrainState,
    latest_step,
    load_eval_weights,
    restore_checkpoint,
    save_checkpoint,
)

# H100 SXM data-sheet peaks (dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12  # dense, on the tensor cores
# IGSO(3) kernel, per element: two f32 loads + two f32 stores (one load when
# sigma is a single value), and the plain version's 89 f32 operations, each
# exp/log/sin/tan/sinh/cosh counted as one: 35 for the wrapped-image terms A
# and A', 27 for the log-density, 27 for the score (itemised in the source)
IGSO3_BYTES, IGSO3_BYTES_ONE_SIGMA, IGSO3_OPS = 16, 12, 89
# MMD kernel: 36 bytes a rotation read once, 4 bytes out; per pair 67 f32
# operations, what the kernel body executes: the four bilinears' 27 FMA (the
# trace 9, each skew component 6) count 54; sx^2 + sy^2 + sz^2 5, sqrt 1, its
# 0.5 scale 1, c = 0.5 (tr - 1) 2, atan2 1, the -sqrt(2) scale 1, exp 1 and
# the accumulate 1
MMD_BYTES_PER_ROT, MMD_OPS_PER_PAIR = 36, 67
# ancestral_steps: the sampling path runs its ancestral chain on a process
# with T = 250; the 1000-step chain at this width is run, and timed, by the
# training phase's --test on its checkpoint
PATH = dict(dim=512, heads=4, layers=4, batch=32, samples=256, timesteps=1000,
            ancestral_steps=250, heun_steps=50, log_prob_n=50_000)
BINGHAM_COV, BINGHAM_N = "lcr", 20_000
# training phases: timed steps after the warm-up, the logging interval of the
# timed runs (each logged row also runs the frozen validation probe, one
# forward), the length of the falling-loss run, its resume, and N of the
# N + save + restore + N check.  The aircraft depths were halved (100 timed
# steps, 200 falling) to make room for the protein phases
TRAIN = dict(warmup=10, timed=50, print_every=20, fall_steps=100, resume_more=20,
             exact_n=10, bingham_steps=2000, bingham_mmd_every=1000,
             bingham_print_every=100)
# Bingham rows: kernel launches each row must make (3 MMD sums per row)
BINGHAM_IGSO3 = {"ancestral_1000": 0, "ddim_50": 0, "ddim_20": 0, "pf_flow_50": 0,
                 "pf_flow_10": 0, "pf_heun_25_karras": 50, "pf_euler_50_karras": 50,
                 "ddim_50_picard": 0}
# protein docking at the headline width: the JAX package's headline arm
# (--se3 --batch 16 --frame-pool --cross-depth 2 --rel-frame --equiv-head
# --bf16), seeded init, the driver's 16 synthetic pairs (120 / 60 residues)
PROTEIN = dict(dim=1024, heads=8, t_depth=12, c_depth=8, cross_depth=2, batch=16,
               timesteps=1000, params=163_077_652, receptor=120, ligand=60)
# Adam's update kernel at the leaf sets of the benchmark's two configurations:
# (leaf set, impl, moment dtype).  Bytes an element: p, g, mu and nu read once,
# p, mu and nu written once
ADAM_SETS = {"planenet-d512": ("planenet", "optax", "f32"),
             "protnet-d1024-prod": ("protnet", "fused", "bf16")}
ADAM_BYTES = {"f32": 28, "bf16": 20}
# the experts layer's row passes at the shapes of each trunk's cell
# (dsv2lite-aircraft-train, kimilinear-aircraft-train): T tokens, top k of
# e experts, `held` of them held, widths d and f.  held_bias lowers the
# held experts' scores so that about as many rows are held as the cell's
# untrained router holds ("cell": ~10,330 of 98,304; ~2,300 of 131,072,
# the Kimi cell's held share 0.56); "all" holds every expert (n = T k)
MOE_ROWS = {"dsv2": dict(t=16_384, k=6, e=64, held=8, d=2048, f=1408, held_bias=-0.105),
            "kimi": dict(t=16_384, k=8, e=256, held=8, d=2304, f=1024, held_bias=-0.25)}
MOE_ROWS_KERNELS = ("moe_gather_rows", "moe_gather_rows_backward", "moe_swiglu_rows",
                    "moe_swiglu_rows_backward", "moe_combine_rows", "moe_combine_rows_backward")
# MLA's attention core at the shapes of each trunk's cell: clouds, points,
# heads, head dims (qk = nope + rope, rope, v) and the rope slice's offset
# in kv_a_proj_with_mqa's rows
MLA_SHAPES = {"dsv2": dict(b=64, n=256, h=16, dqk=192, dr=64, dv=128, rank=512),
              "kimi": dict(b=16, n=1024, h=32, dqk=192, dr=64, dv=128, rank=512)}
MLA_KERNELS = ("mla_attention_forward_kernel", "mla_attention_dq_kernel", "mla_attention_dkv_kernel")
PROTEIN_ARGV = ["--se3", "--bf16", "--dim", "1024", "--heads", "8", "--t_depth", "12",
                "--c_depth", "8", "--frame-pool", "--cross-depth", "2", "--rel-frame",
                "--equiv-head", "--batch", "16", "--timesteps", "1000",
                "--data-root", "/nonexistent"]
# --test rows: (name, flags, samples per pose, model evaluations a chain, IGSO(3)
# launches).  The ancestral chain runs one sample per pose (16 poses): four
# would add ~20 s to the script
PROTEIN_ROWS = [
    ("ddim_50", ["--sampler", "ddim", "--sampler-steps", "50"], 4, 51, 0),
    ("pf_flow_50", ["--sampler", "pf", "--sampler-steps", "50"], 4, 51, 0),
    ("pf_heun_25", ["--sampler", "pf", "--pf-method", "heun", "--sampler-steps", "25"], 4, 51,
     2 * 25 * 4),
    ("picard_10", ["--sampler", "picard", "--sampler-steps", "10"], 4, None, 0),
    ("ancestral_1000", [], 1, 1000, 0),
]
# the sampler rows evaluate the seeded init with its output layer scaled by
# this: at the init's own scale an untrained head's predicted shift moves the
# ligand, whose pooled position feeds the head back, and the shift grows
# ~10x a chain step until float32 overflows (measured on the CPU at dim 1024)
PROTEIN_HEAD_SCALE = 1e-2
# protein training: timed steps after the warm-up (bench.py's protein_train_b16
# protocol), the falling-loss run, N of N + save + restore + N, epochs of
# --epoch-accum
PROTEIN_TRAIN = dict(timed=96, fall_steps=200, exact_n=8, accum_epochs=2)
# the Euler arms: the aircraft arm at PATH's width (bf16 K = 8 timed steps,
# fp32 K = 1 for the falling loss, --test one chain per shape over 32
# shapes); the protein arm at the headline width with the production flags
# (--test: the 1000-step ancestral chain, one sample a pose, on the seeded
# init with its output layer scaled by PROTEIN_HEAD_SCALE)
EULER = dict(fall_steps=100, test_shapes=32)
PROTEIN_EULER_ARGV = [a for a in PROTEIN_ARGV if a != "--se3"]
# the two small suites: so3_toy (RotPredict d65, batch 64) and both lock arms
# (batch 32, eager steps), cut from 200,000 / 100,000 steps; --test over 512
# chains
SUITES = dict(toy_steps=2000, toy_k=16, lock_steps=2000, eval_batch=512)
# the jigsaw suite at the JAX driver's width (CoordConv size 128, batch 256,
# T = 1000, seeded init): 10 + 50 timed eager steps, 200 whose loss must fall
# (cut from 40,000), steps timed with and without cuDNN's deterministic
# algorithms, --test over 64 chains
JIGSAW = dict(size=128, batch=256, timesteps=1000, warmup=10, timed=50, fall_steps=200,
              det_steps=20, eval_batch=64)
# the diagnostics: se3-path and grad_check at their defaults, IGSO3xR3.log_prob
# over 50,000 poses
DIAG = dict(se3_samples=14, se3_steps=1000, grad_iters=2000, log_prob_n=50_000)
# the Switch-MoE aircraft arm (bench.py's moe_train_e4): replayed --bf16 K = 8
# steps, the logging interval (each row runs the probe and reads the expert
# fractions)
MOE = dict(experts=4, steps=208, print_every=8)
# a NCCL group of one: replayed --bf16 K = 8 steps through the all-reduce,
# and --fsdp's eager steps
DP_WORLD1 = dict(steps=16, fsdp_steps=20)
# the DeepSeek-V2 trunk (--trunk dsv2lite-ep8) at the dsv2lite-aircraft-train
# cell's size: replayed bf16 K = 8 steps through aircraft.main, then one
# profiled call of a fresh step
DSV2 = dict(trunk="dsv2lite-ep8", batch=64, samples=256, params=487_890_436, steps=32, print_every=8)
# the Kimi Linear trunk (--trunk kimilinear-ep32) at the
# kimilinear-aircraft-train cell's size, the same way
KIMI = dict(trunk="kimilinear-ep32", batch=16, samples=1024, params=514_730_756, steps=16, print_every=8)
# bench_torch --quick: the headline and its eleven rows, the kernel-2
# launches of mmd_eval (one warm-up call and three timed, three sums each)
BENCH_MEASUREMENTS, BENCH_MMD_LAUNCHES = 12, 12
# the sweep: two lock runs (--param so3) over this grid, each this many steps
SWEEP = dict(grid={"lr": [1e-4, 3e-4]}, steps=50, print_every=10)
# the probe: the headline flags' checkpoint after one replayed K = 8 call
PROBE = dict(train_steps=8)
# kernel 1's timed cases: (key suffix in the kernels line, n, one sigma); the
# unsuffixed case is the aircraft batch
IGSO3_CASES = [("", PATH["batch"], False), ("_16", PROTEIN["batch"], False), ("_20k", BINGHAM_N, False),
               ("_1m", 2**20, False), ("_50k_one_sigma", PATH["log_prob_n"], True),
               ("_1m_one_sigma", 2**20, True)]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def kernel_launches() -> dict:
    """Each kernel's launches since the last ``obs.reset()``."""
    return {name: obs.counter(spec["counter"]) for name, spec in KERNELS.items()}


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


def igso3_bound_ms(n: int, one_sigma: bool = False) -> tuple[float, str]:
    t_bytes = (IGSO3_BYTES_ONE_SIGMA if one_sigma else IGSO3_BYTES) * n / HBM_BYTES_PER_S
    t_ops = IGSO3_OPS * n / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def mmd_bound_ms(n: int, m: int) -> tuple[float, str]:
    t_bytes = (MMD_BYTES_PER_ROT * (n + m) + 4) / HBM_BYTES_PER_S
    t_ops = MMD_OPS_PER_PAIR * n * m / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def coordconv_flops(size: int, dim: int = 16) -> tuple[float, float]:
    """(forward FLOPs of one image, those of its train step): 2 x 9 Cin Cout
    H W a 3x3 conv; a train step adds each conv's weight gradient (its
    forward's FLOPs again) and the input gradient of every conv but the
    first (the rendered image needs none).  ELU, pooling and the mean are
    not counted."""
    convs, hw, cin = [], size, 3 + 2 + dim
    for n in STAGES:
        for _ in range(n):
            convs.append(2 * 9 * cin * WIDTH * hw * hw)
            cin = WIDTH
        hw //= 2
    convs.append(2 * 9 * WIDTH * 2 * hw * hw)
    fwd = float(sum(convs))
    return fwd, 3 * fwd - convs[0]


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


def gate(got: torch.Tensor, want: torch.Tensor, rtol: float, atol):
    """(max |got - want|, max |got - want| / (atol + rtol |want|)); ``atol``
    is a number or a tensor that broadcasts against ``want``."""
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


def phase_build() -> dict:
    """The kernels' nvcc builds, started together; returns each kernel's
    SASS instruction counts, or "not available" without cuobjdump."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        futures = [pool.submit(spec["module"].build) for spec in KERNELS.values()]
        for fut in futures:
            fut.result()
    sass = {}
    for name, spec in KERNELS.items():
        mod = spec["module"]
        ptxas = [ln.strip() for ln in mod.build_log.splitlines() if "ptxas" in ln]
        sass[name] = _build.sass_summary(mod.library_path) or "not available"
        emit("build", kernel=name, seconds=time.perf_counter() - t0, ptxas=ptxas,
             sass=sass[name])
    return sass


def sass_counts(sass: dict) -> dict:
    """What the kernels line keeps of the SASS: the MMD kernel's inner loop
    per pair (one MUFU.EX2 a pair), the whole of the IGSO(3) kernel (both
    arithmetic paths), each Adam kernel's instruction count, or "not
    available"."""
    out = {"gaussian_kernel_sum": "not available", "igso3_logpdf_score": "not available",
           "adam_update": sass_instructions(sass["adam_update"]),
           "moe_rows": sass_instructions(sass["moe_rows"]),
           "mla_attention": sass_instructions(sass["mla_attention"])}
    mmd_fns = sass["gaussian_kernel_sum"]
    if isinstance(mmd_fns, dict):
        for name, fn in mmd_fns.items():
            loop = fn["loop"]
            if "tile_sums" in name and loop and loop["ex2"]:
                out["gaussian_kernel_sum"] = {
                    k: v / loop["ex2"] for k, v in loop.items() if k != "ex2"}
    igso3_fns = sass["igso3_logpdf_score"]
    if isinstance(igso3_fns, dict):
        for name, fn in igso3_fns.items():
            if "igso3_logpdf_score_kernel" in name:
                out["igso3_logpdf_score"] = {k: v for k, v in fn.items() if k != "loop"}
    return out


def sass_instructions(fns) -> dict | str:
    """Each kernel function's instruction count, or "not available"."""
    if not isinstance(fns, dict):
        return "not available"
    return {name: fn["instructions"] for name, fn in fns.items()}


def igso3_cases():
    """Kernel 1 at IGSO3_CASES: ms / plain_ms device time a call (CUDA graph
    replay); call_ms / plain_call_ms an eager call from Python, what a
    chain pays."""
    for suffix, n, one_sigma in IGSO3_CASES:
        t, s = kernel_inputs(n, seed=1)
        if one_sigma:
            s = torch.tensor(0.5, device="cuda")
        kernel = lambda: igso3_cuda.igso3_logpdf_score(t, s)  # noqa: E731
        plain = lambda: igso3_cuda.igso3_logpdf_score_ref(t, s)  # noqa: E731
        bound_ms, bound_by = igso3_bound_ms(n, one_sigma)
        yield suffix, dict(zip(("logf", "score"), kernel())), dict(zip(("logf", "score"), plain())), \
            igso3_cuda.GATES, dict(
            n=n, ms=time_graph(kernel), plain_ms=time_graph(plain, reps=20), call_ms=time_cuda(kernel, 1000),
            plain_call_ms=time_cuda(plain, 100), bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def rotations(n: int, seed: int, scale: float = 1.0) -> torch.Tensor:
    v = np.random.default_rng(seed).standard_normal((n, 3)).astype(np.float32) * scale
    return exp_skewvec(torch.from_numpy(v).cuda())


def mmd_cases():
    """Kernel 2 at the Bingham path's 20k x 20k, an eager call timed (one
    call is long enough), the plain version summed in 4000 x 4000 blocks."""
    n = BINGHAM_N
    x, y = rotations(n, 9), rotations(n, 10, 0.7)
    kernel = lambda: mmd_cuda.gaussian_kernel_sum(x, y)  # noqa: E731
    plain = lambda: mmd_cuda.gaussian_kernel_sum_ref(x, y, chunksize=4000)  # noqa: E731
    bound_ms, bound_by = mmd_bound_ms(n, n)
    yield "", {"sum": kernel()}, {"sum": plain()}, mmd_cuda.GATES, dict(
        n=n, m=n, ms=time_cuda(kernel, 20, warmup=3), plain_ms=time_cuda(plain, 3, warmup=1),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def adam_leaf_shapes(kind: str) -> list:
    """The parameter shapes of a benchmark configuration's model (built on
    the meta device: nothing allocated)."""
    with torch.device("meta"):
        if kind == "planenet":
            model = PlaneNet(dim=PATH["dim"], heads=PATH["heads"], layers=PATH["layers"])
        else:
            model = ProtNet(dim=PROTEIN["dim"], heads=PROTEIN["heads"],
                            t_depth=PROTEIN["t_depth"], c_depth=PROTEIN["c_depth"],
                            frame_pool=True, cross_depth=PROTEIN["cross_depth"],
                            rel_frame=True, equiv_head=True, bf16=True)
    return [p.shape for p in model.parameters()]


def adam_cases():
    """Kernel 3 at the leaf sets of the benchmark's two configurations
    (``ADAM_SETS``), the kernel and the plain version each from one state:
    their first updates compared, then device ms a call (a CUDA graph
    replayed) of the kernel, of the plain version and, with float32
    moments, of ``torch.optim.Adam(fused=True)`` as a yardstick the port
    never calls, and the eager call's ms (host and device)."""
    for name, (kind, impl, dtype) in ADAM_SETS.items():
        shapes = adam_leaf_shapes(kind)
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = [torch.randn(s, device="cuda", generator=gen) * 0.02 for s in shapes]
        grads = [torch.randn(s, device="cuda", generator=gen) * 1e-3 for s in shapes]
        moment = torch.bfloat16 if dtype == "bf16" else torch.float32
        mine = [params] + [[torch.zeros_like(p, dtype=moment) for p in params] for _ in range(2)]
        ref = [[x.clone() for x in xs] for xs in mine]
        scalars = [torch.tensor(v, device="cuda") for v in (1e-4, 0.1, 1e-3)]
        kw = dict(impl=impl, b1=0.9, b2=0.999, eps=1e-8, clip=0.0)

        def run():
            adam_cuda.adam_update(mine[0], grads, mine[1], mine[2], *scalars, None, **kw)

        def run_plain():
            adam_cuda.adam_update_ref(ref[0], grads, ref[1], ref[2], *scalars, None, **kw)

        run()
        run_plain()
        got, want = ({k: [x.clone() for x in xs] for k, xs in zip(("weights", "mu", "nu"), state)}
                     for state in (mine, ref))
        n = sum(p.numel() for p in params)
        bound_ms = ADAM_BYTES[dtype] * n / HBM_BYTES_PER_S * 1e3
        timing = dict(leaves=len(shapes), n=n, impl=impl, state_dtype=dtype,
                      ms=time_graph(run), plain_ms=time_graph(run_plain, reps=10),
                      call_ms=time_cuda(run, 50), plain_call_ms=time_cuda(run_plain, 10, warmup=2),
                      bound_ms=bound_ms, bound_by="bytes", library_ms=None)
        if dtype == "f32":
            lib = [torch.nn.Parameter(q) for q in ref[0]]
            for q, g in zip(lib, grads):
                q.grad = g
            timing["library_ms"] = time_graph(torch.optim.Adam(lib, lr=1e-4, fused=True, capturable=True).step)
        timing["roofline_pct"] = 100.0 * bound_ms / timing["ms"]
        yield f"_{name}", got, want, adam_cuda.GATES, timing


def moe_rows_operands(c: dict, case: str, seed: int = 0) -> dict:
    """A routing drawn on the card at the shapes ``c`` (``"cell"`` or
    ``"all"``), its plan, and each pass's inputs and incoming gradients,
    rows past n filled with NaN (the kernels never read them)."""
    t, k, d, f = c["t"], c["k"], c["d"], c["f"]
    held = c["e"] if case == "all" else c["held"]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    scores = torch.randn(t, c["e"], generator=gen, device="cuda")
    if case == "cell":
        scores[:, :held] += c["held_bias"]
    top_i = scores.topk(k, dim=-1).indices
    order, inv, _, offs = moe_rows_cuda.dispatch_plan(top_i, 0, held)
    n = int(offs[-1])

    def rnd(*shape, dt=torch.bfloat16, past_n=False):
        x = torch.randn(*shape, generator=gen, device="cuda").to(dt)
        if past_n:
            x[n:] = float("nan")
        return x

    r = t * k
    return dict(order=order, inv=inv, offs=offs, mine=top_i < held, n=n, t=t, k=k, d=d, f=f,
                tokens=rnd(t, d, dt=torch.float32), w=torch.rand(t, k, generator=gen, device="cuda"),
                grad_xs=rnd(r, d, past_n=True), h1=rnd(r, 2 * f, past_n=True),
                grad_h=rnd(r, f, past_n=True), ys=rnd(r, d, past_n=True),
                grad_out=rnd(t, d, dt=torch.float32))


def moe_rows_bytes(o: dict) -> dict:
    """Each kernel's bytes: every input byte it needs read once, every
    output byte written once, at these operands' n (bf16 rows: 2 bytes;
    float32 tokens, weights and results: 4; int64 order and inv: 8).  The
    gather reads the tokens with a held choice once each."""
    n, t, k, d, f = o["n"], o["t"], o["k"], o["d"], o["f"]
    used = int(o["mine"].any(dim=1).sum())
    return {"moe_gather_rows": used * d * 4 + n * d * 2 + n * 8,
            "moe_gather_rows_backward": n * d * 2 + t * k * 8 + t * d * 4,
            "moe_swiglu_rows": n * 2 * f * 2 + n * f * 2,
            "moe_swiglu_rows_backward": n * f * 2 + n * 2 * f * 2 + n * 2 * f * 2,
            "moe_combine_rows": n * d * 2 + t * k * 12 + t * d * 4,
            "moe_combine_rows_backward": t * d * 4 + n * d * 2 + t * k * 12 + n * d * 2 + t * k * 4}


def moe_rows_cases():
    """Kernel 4's six kernels at each trunk's MOE_ROWS shapes, at the cell's
    held rows (``"cell"``) and at all T k (``"all"``): each pass forward and backward
    through its wrapper against its plain version (autograd), the rows
    under n and the per-token results to the bit, the combine's gradient
    of the weights within ``grad_w_atol``; then each kernel launched into
    outputs allocated once: its device ms (a CUDA graph replayed) beside
    its bytes bound, and the plain version's ms (its forward, or its
    backward alone through ``torch.autograd.grad``)."""
    mr = moe_rows_cuda
    for trunk, case in itertools.product(MOE_ROWS, ("cell", "all")):
        o = moe_rows_operands(MOE_ROWS[trunk], case)
        n, order, inv, offs, t, k, d, f = (o[key] for key in ("n", "order", "inv", "offs", "t", "k", "d", "f"))
        res = {}
        for kernel in (True, False):
            tokens = o["tokens"].clone().requires_grad_(True)
            xs = (mr.gather if kernel else mr.gather_ref)(tokens, order, inv, offs, torch.bfloat16)
            (dtok,) = torch.autograd.grad(xs, [tokens], o["grad_xs"])
            h1 = o["h1"].clone().requires_grad_(True)
            h = mr.swiglu(h1, offs) if kernel else mr.swiglu_ref(h1)
            (dh1,) = torch.autograd.grad(h, [h1], o["grad_h"])
            ys, w = o["ys"].clone().requires_grad_(True), o["w"].clone().requires_grad_(True)
            y = (mr.combine if kernel else mr.combine_ref)(ys, w, inv, offs)
            dys, dw = torch.autograd.grad(y, [ys, w], o["grad_out"])
            # each kernel's outputs compared
            res[kernel] = {"moe_gather_rows": {"rows": xs.detach()[:n]},
                           "moe_gather_rows_backward": {"rows": dtok},
                           "moe_swiglu_rows": {"rows": h.detach()[:n]},
                           "moe_swiglu_rows_backward": {"rows": dh1[:n]},
                           "moe_combine_rows": {"rows": y.detach()},
                           "moe_combine_rows_backward": {"rows": dys[:n], "grad_w": dw}}
        gates = {**mr.GATES, "grad_w": (0.0, mr.grad_w_atol(o["grad_out"], o["ys"], inv, o["mine"]))}

        def empty(*shape, dt=torch.bfloat16):
            return torch.empty(shape, device="cuda", dtype=dt)

        xs, tok, h, dh1 = empty(t * k, d), empty(t, d, dt=torch.float32), empty(t * k, f), empty(t * k, 2 * f)
        y, dys, dw = empty(t, d, dt=torch.float32), empty(t * k, d), empty(t, k, dt=torch.float32)
        tokens, h1 = o["tokens"].clone().requires_grad_(True), o["h1"].clone().requires_grad_(True)
        ys, w = o["ys"].clone().requires_grad_(True), o["w"].clone().requires_grad_(True)
        xs_p, h_p, y_p = (mr.gather_ref(tokens, order, inv, offs, torch.bfloat16), mr.swiglu_ref(h1),
                          mr.combine_ref(ys, w, inv, offs))
        # kernel: (its launch, the plain version)
        runs = {
            "moe_gather_rows": (lambda: mr.launch_gather(o["tokens"], order, offs, xs),
                                lambda: mr.gather_ref(o["tokens"], order, inv, offs, torch.bfloat16)),
            "moe_gather_rows_backward": (
                lambda: mr.launch_gather_backward(o["grad_xs"], inv, offs, tok),
                lambda: torch.autograd.grad(xs_p, [tokens], o["grad_xs"], retain_graph=True)),
            "moe_swiglu_rows": (lambda: mr.launch_swiglu(o["h1"], offs, h), lambda: mr.swiglu_ref(o["h1"])),
            "moe_swiglu_rows_backward": (
                lambda: mr.launch_swiglu_backward(o["grad_h"], o["h1"], offs, dh1),
                lambda: torch.autograd.grad(h_p, [h1], o["grad_h"], retain_graph=True)),
            "moe_combine_rows": (lambda: mr.launch_combine(o["ys"], o["w"], inv, offs, y),
                                 lambda: mr.combine_ref(o["ys"], o["w"], inv, offs)),
            "moe_combine_rows_backward": (
                lambda: mr.launch_combine_backward(o["grad_out"], o["ys"], o["w"], inv, offs, dys, dw),
                lambda: torch.autograd.grad(y_p, [ys, w], o["grad_out"], retain_graph=True)),
        }
        nbytes = moe_rows_bytes(o)
        for name, (kernel, plain) in runs.items():
            with torch.set_grad_enabled("backward" in name):
                plain_ms = time_cuda(plain, 10, warmup=2)
            bound_ms = nbytes[name] / HBM_BYTES_PER_S * 1e3
            ms = time_graph(kernel, reps=20)
            yield f"_{name}_{trunk}_{case}", res[True][name], res[False][name], gates, dict(
                n=n, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bytes=nbytes[name], bound_by="bytes",
                roofline_pct=100.0 * bound_ms / ms)
        del o, res, runs, xs_p, h_p, y_p
        torch.cuda.empty_cache()


def mla_attention_bound(c: dict) -> dict:
    """(bytes, FLOPs) of the forward and of the backward at the shapes ``c``:
    every input byte read once and every output byte written once (bf16
    rows, float32 log-sum-exp; the backward's D is its own scratch and not
    counted), and the products: 2 B H N^2 (qk + v) forward (S, P v), 2 B H
    N^2 (2 qk + 2 v) backward (dP, dv, dk, dq) without the recomputed S."""
    b, n, h, dqk, dr, dv = (c[k] for k in ("b", "n", "h", "dqk", "dr", "dv"))
    rows = b * n
    q, kv, kpe = rows * h * dqk * 2, rows * h * (dqk - dr + dv) * 2, rows * dr * 2
    o, lse = rows * h * dv * 2, rows * h * 4
    pairs = 2 * b * h * n * n
    return {"forward": (q + kv + kpe + o + lse, pairs * (dqk + dv)),
            "backward": (2 * (q + kv + kpe) + 2 * o + lse, pairs * 2 * (dqk + dv))}


def mla_attention_cases():
    """Kernel 5 at each trunk's MLA_SHAPES: the forward and the backward through the
    wrapper against the plain version (autograd, the same bf16 inputs), each
    output within the module's GATES; then the forward's launch and the
    backward's two, into outputs allocated once: device ms (a CUDA graph
    replayed) beside the bound (bytes or FLOPs, whichever is the larger
    time) and the plain version's ms (its forward, or its backward alone
    through ``torch.autograd.grad``)."""
    from diffusion_extensions_tpu_torch.models.deepseek_v2 import DEEPSEEK_V2_LITE
    from diffusion_extensions_tpu_torch.models.kimi_linear import KIMI_LINEAR_48B

    scales = {"dsv2": DEEPSEEK_V2_LITE.softmax_scale, "kimi": KIMI_LINEAR_48B.deepseek().softmax_scale}
    for trunk, c in MLA_SHAPES.items():
        yield from mla_attention_trunk_cases(trunk, c, scales[trunk])
        torch.cuda.empty_cache()


def mla_attention_trunk_cases(trunk: str, c: dict, scale: float):
    """``mla_attention_cases`` at one trunk's shapes ``c``."""
    m = mla_attention_cuda
    b, n, h, dqk, dr, dv = (c[k] for k in ("b", "n", "h", "dqk", "dr", "dv"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [torch.randn(b, n, w, generator=gen, device="cuda").bfloat16()
            for w in (h * dqk, h * (dqk - dr + dv), c["rank"] + dr)]
    grad = torch.randn(b, n, h, dv, generator=gen, device="cuda").bfloat16()

    def views(requires_grad=True):
        q, kv, kpe = rows[0].view(b, n, h, dqk), rows[1].view(b, n, h, -1), rows[2][..., c["rank"]:]
        return [x.detach().requires_grad_(requires_grad) for x in (q, kv, kpe)]

    res = {}
    for kernel in (True, False):
        ins = views()
        o = (m.attention if kernel else m.attention_ref)(*ins, scale)
        dq, dkv, dkpe = torch.autograd.grad(o, ins, grad)
        res[kernel] = {"forward": {"o": o.detach()}, "backward": {"dq": dq, "dkv": dkv, "dk_pe": dkpe}}
    q, kv, kpe = views(False)
    o, lse = torch.empty(b, n, h, dv, device="cuda", dtype=torch.bfloat16), torch.empty(b, h, n, device="cuda")
    delta = torch.empty_like(lse)
    dq, dkv, dkpe = (torch.empty(x.shape, device="cuda", dtype=torch.bfloat16) for x in (q, kv, kpe))
    ins = views()
    o_p = m.attention_ref(*ins, scale)
    runs = {"forward": (lambda: m.launch_forward(q, kv, kpe, scale, o, lse),
                        lambda: m.attention_ref(q, kv, kpe, scale)),
            "backward": (lambda: m.launch_backward(q, kv, kpe, scale, o, lse, grad, delta, dq, dkv, dkpe),
                         lambda: torch.autograd.grad(o_p, ins, grad, retain_graph=True))}
    bound = mla_attention_bound(c)
    for name, (kernel, plain) in runs.items():
        with torch.set_grad_enabled(name == "backward"):
            plain_ms = time_cuda(plain, 10, warmup=2)
        nbytes, flops = bound[name]
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_OPS_PER_S * 1e3
        ms = time_graph(kernel, reps=20)
        yield f"_{name}_{trunk}", res[True][name], res[False][name], m.GATES, dict(
            ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops), bytes=nbytes, flops=flops,
            bound_by="bytes" if t_bytes >= t_ops else "operations", roofline_pct=100.0 * max(t_bytes, t_ops) / ms)


# the kernels: their launch counter, wrapper module (its GATES: each
# output's gate against the plain version), the Pallas kernel each replaces,
# the key of its SASS summary and its timed cases, each case yielding (key
# suffix, the kernel's outputs, the plain version's, their gates, the
# timings).  The source of each is csrc/<name>.cu
KERNELS = {
    "igso3_logpdf_score": dict(counter="ops.igso3.launches", module=igso3_cuda,
                               replaces="diffusion_extensions_tpu/ops/igso3_pallas.py:101",
                               sass="sass_instructions", cases=igso3_cases),
    "gaussian_kernel_sum": dict(counter="ops.mmd.launches", module=mmd_cuda,
                                replaces="diffusion_extensions_tpu/ops/mmd_pallas.py:112",
                                sass="sass_per_pair", cases=mmd_cases),
    "adam_update": dict(counter="ops.adam.launches", module=adam_cuda, replaces=None, sass="sass_instructions",
                        cases=adam_cases),
    "moe_rows": dict(counter="ops.moe_rows.launches", module=moe_rows_cuda, replaces=None,
                     sass="sass_instructions", cases=moe_rows_cases),
    "mla_attention": dict(counter="ops.mla_attention.launches", module=mla_attention_cuda, replaces=None,
                          sass="sass_instructions", cases=mla_attention_cases),
}


def agreement(got: dict, want: dict, gates: dict) -> dict:
    """Each output's largest |kernel - plain| (``<output>_max_abs_err``),
    the largest of them, that over the plain output's largest |value|
    (``max_rel_err``), and the largest |kernel - plain| / (atol + rtol
    |plain|) under each output's gate (``gate_ratio``; under None, 0 for
    the same bits, else inf).  An output is a tensor or a list of them."""
    out = {"max_abs_err": 0.0, "max_rel_err": 0.0, "gate_ratio": 0.0}
    for name in got:
        tol = gates[name]
        pairs = zip(*(x if isinstance(x, list) else [x] for x in (got[name], want[name])))
        for a, b in pairs:
            diff = (a.float() - b.float()).abs()
            err = float(diff.max())
            out[f"{name}_max_abs_err"] = max(out.get(f"{name}_max_abs_err", 0.0), err)
            out["max_abs_err"] = max(out["max_abs_err"], err)
            out["max_rel_err"] = max(out["max_rel_err"], err / max(float(b.float().abs().max()), 1e-30))
            ratio = ((0.0 if torch.equal(a, b) else math.inf) if tol is None
                     else float((diff / (tol[1] + tol[0] * b.float().abs()).clamp_min(1e-30)).max()))
            out["gate_ratio"] = max(out["gate_ratio"], ratio)
    return out


def phase_kernels() -> dict:
    """Each kernel of KERNELS at its timed cases: a ``kernel_time`` line a
    case; returns each kernel's record, its timings under the case's key
    suffix, the largest of its distances from the plain version, and
    ``pass``: whether those lie inside the kernel's gates."""
    records = {}
    for name, spec in KERNELS.items():
        rec, errs = {}, []
        for suffix, got, want, gates, timing in spec["cases"]():
            errs.append(agreement(got, want, gates))
            emit("kernel_time", kernel=name, case=suffix.lstrip("_"), **timing, **errs[-1])
            rec.update({f"{k}{suffix}": v for k, v in timing.items()})
            sync()
            torch.cuda.empty_cache()
        keys = dict.fromkeys(k for e in errs for k in e)  # a case may compare fewer outputs
        rec.update({k: max(e.get(k, 0.0) for e in errs) for k in keys})
        rec["pass"] = rec["gate_ratio"] <= 1.0
        records[name] = rec
    return records


def read_jsonl(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f]


def run_captured(fn, argv):
    """``fn(argv)`` with its standard output passed on and returned."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(argv)
    print(buf.getvalue(), end="", flush=True)
    return out, buf.getvalue()


def evaluate(main, argv):
    """``main(argv)``, an experiment's ``--test`` run, with its output passed
    on; raises where it found no weights to evaluate."""
    res, out = run_captured(main, argv)
    if "no checkpoint found" in out:
        raise AssertionError(f"{main.__module__} {argv}: evaluated an untrained model")
    return res, out


def falling_run(name: str, main, argv: list, tmp: str, steps: int, window: int = 10, calls: int | None = None):
    """``main(argv)`` trained ``steps`` steps with a row logged a call (``calls``
    rows, ``steps`` by default): every loss finite and the mean of the last
    ``window`` rows below that of the first; returns the rows, the
    checkpoint directory and the log."""
    ckpt, log = os.path.join(tmp, f"{name}_fall"), os.path.join(tmp, f"{name}_fall.jsonl")
    run_captured(main, argv + ["--steps", str(steps), "--print-every", "1", "--ckpt", ckpt, "--log", log])
    rows = read_jsonl(log)
    first, last = ([r["loss"] for r in part] for part in (rows[:window], rows[-window:]))
    emit(name, run="falling_loss", steps=steps, rows=len(rows), window=window, losses_first=first,
         losses_last=last, loss_first=float(np.mean(first)), loss_last=float(np.mean(last)),
         test_loss_first=rows[0].get("test_loss"), test_loss_last=rows[-1].get("test_loss"))
    if len(rows) != (calls or steps) or not all(np.isfinite(r["loss"]) for r in rows) \
            or not np.mean(last) < np.mean(first):
        raise AssertionError(f"{name}: loss did not fall ({first} -> {last})")
    return rows, ckpt, log


def check_rotations(name: str, r: torch.Tensor) -> dict:
    assert r.shape == (PATH["batch"], 3, 3), (name, r.shape)
    assert torch.isfinite(r).all(), name
    eye = torch.eye(3, device=r.device)
    orth = float((r.transpose(-1, -2) @ r - eye).abs().max())
    det = float((torch.linalg.det(r).abs() - 1.0).abs().max())
    if not (orth < 1e-4 and det < 1e-4):
        raise AssertionError(f"{name}: |R^T R - I| = {orth}, ||det R| - 1| = {det}")
    return {"orth_err": orth, "det_err": det}


def aircraft_test(name: str, argv: list, shapes: int) -> str:
    """``aircraft.main(argv + --test)`` over ``shapes`` shapes, one 1000-step
    chain a shape: every angle finite, the first call's rotations on SO(3);
    returns what ``aircraft.main`` printed."""
    sampled, sample = [], aircraft.sample_rotations

    def recorded(*a, **kw):
        sampled.append(sample(*a, **kw))
        return sampled[-1]

    t0 = time.perf_counter()
    with mock.patch.object(aircraft, "SAMPLES_PER_SHAPE", 1), \
            mock.patch.object(aircraft, "sample_rotations", recorded):
        res, out = evaluate(aircraft.main, argv + ["--test", "--max-shapes", str(shapes)])
    sync()
    emit(name, run="test_on_checkpoint", seconds=time.perf_counter() - t0, samples=len(res),
         chains=len(sampled), steps=PATH["timesteps"], median_angle=float(np.median(res)),
         **check_rotations(f"{name} --test", sampled[0]))
    if res.shape != (shapes,) or not np.isfinite(res).all():
        raise AssertionError(f"{name} --test: angles {res}")
    return out


def aircraft_proj(device) -> PointCloudProj:
    """The projection of PATH's batch of aircraft clouds."""
    clouds = subsample_points(synthetic_planes(128, seed=2), PATH["samples"], seed=17)
    return PointCloudProj(torch.from_numpy(clouds[: PATH["batch"]]).to(device))


def forward_ms(model, proj) -> float:
    """ms of one inference-mode forward of the aircraft denoiser at PATH's
    batch, t = 500."""
    x_in = proj(torch.eye(3, device="cuda").expand(PATH["batch"], 3, 3))
    t_in = torch.full((PATH["batch"],), 500, device="cuda")
    with torch.inference_mode():
        return time_cuda(lambda: model(x_in, t_in), 10, warmup=3)


def phase_path(tmp: str) -> None:
    """The aircraft sampling path at full width: the forward's ms, the
    ancestral chain, Heun-50 and ``log_prob`` on 50,000 rotations."""
    device = torch.device("cuda")
    t0 = time.perf_counter()
    torch.manual_seed(0)
    model = PlaneNet(dim=PATH["dim"], heads=PATH["heads"], layers=PATH["layers"]).to(device).eval()
    process = ProjectedSO3Diffusion(PATH["timesteps"], device=device)
    short_process = ProjectedSO3Diffusion(PATH["ancestral_steps"], device=device)
    proj = aircraft_proj(device)
    dist = IsotropicGaussianSO3.create(0.5, device=device)
    sync()
    setup_s = time.perf_counter() - t0
    fwd_ms = forward_ms(model, proj)
    flops = planenet_flops(PATH["dim"], PATH["layers"], PATH["batch"], PATH["samples"])
    emit("path_setup", seconds=setup_s, params=sum(p.numel() for p in model.parameters()),
         forward_ms=fwd_ms, forward_gflop=flops / 1e9,
         forward_tflops=flops / fwd_ms / 1e9, **PATH)

    gen = torch.Generator(device=device).manual_seed(1)
    runs = {}
    with torch.inference_mode():
        before = obs.counter("ops.igso3.launches")
        t0 = time.perf_counter()
        r_anc = short_process.p_sample_loop(model, gen, (PATH["batch"],), proj)
        sync()
        runs["ancestral"] = dict(seconds=time.perf_counter() - t0, steps=PATH["ancestral_steps"],
                                 launches=obs.counter("ops.igso3.launches") - before,
                                 **check_rotations("ancestral", r_anc))

        before = obs.counter("ops.igso3.launches")
        t0 = time.perf_counter()
        r_heun = process.pf_sample_loop(model, gen, (PATH["batch"],), PATH["heun_steps"],
                                        proj, method="heun")
        sync()
        runs["pf_heun"] = dict(seconds=time.perf_counter() - t0, steps=PATH["heun_steps"],
                               launches=obs.counter("ops.igso3.launches") - before,
                               **check_rotations("pf_heun", r_heun))

        samples = dist.sample(gen, (PATH["log_prob_n"],))
        sync()
        before = obs.counter("ops.igso3.launches")
        t0 = time.perf_counter()
        lp = dist.log_prob(samples)
        sync()
        runs["log_prob"] = dict(seconds=time.perf_counter() - t0, n=PATH["log_prob_n"],
                                launches=obs.counter("ops.igso3.launches") - before)

    assert lp.shape == (PATH["log_prob_n"],) and torch.isfinite(lp).all()
    ref = igso3_log_density(rotation_angle(samples), dist.eps)
    la, lg = gate(lp, ref, *igso3_cuda.GATES["logf"])
    runs["log_prob"].update(max_abs_err_vs_plain=la, gate_ratio=lg)
    for name, run in runs.items():
        emit("path_run", run=name, **run)
    want = {"ancestral": 0, "pf_heun": 2 * PATH["heun_steps"], "log_prob": 1}
    got = {k: runs[k]["launches"] for k in want}
    if got != want:
        raise AssertionError(f"IGSO(3) kernel launches {got}, expected {want}")
    if lg > 1.0:
        raise AssertionError(f"log_prob disagrees with the plain density: {la}")


def phase_bingham_path(tmp: str) -> None:
    """experiments/bingham.py --test --sampler-ab at full size, seeded init,
    records into ``tmp``."""
    if (bingham.SAMPLES, bingham.NET_SAMPLES) != (BINGHAM_N, BINGHAM_N):
        raise AssertionError(f"bingham.SAMPLES = {bingham.SAMPLES}, expected {BINGHAM_N}")
    t0 = time.perf_counter()
    rows = bingham.main([BINGHAM_COV, "--test", "--sampler-ab", "--timesteps", "1000",
                         "--out-dir", tmp, "--ckpt", os.path.join(tmp, "none.pt")])[BINGHAM_COV]
    seconds = time.perf_counter() - t0
    files = sorted(os.listdir(tmp))
    for r in rows:
        emit("bingham_run", sampler=r["sampler"], seconds=r["sample_seconds"],
             model_evals=r["model_evals"], mmd=r["mmd"], passes=r["passes"],
             accept_threshold=r["accept_threshold"], sweeps=r.get("sweeps"),
             launches=r["launches"], orth_err=r["orth_err"], det_err=r["det_err"],
             count=r["count"])
    emit("bingham_path", seconds=seconds, launches=kernel_launches(), files=files)
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


def exact_resume_check(tmp: str, argv=("--so3",)) -> dict:
    """At full width, from the same init and the same batches: 2N eager
    steps against N + save + restore + N, against 2N steps in calls of 5
    (one CUDA graph replayed a sub-step), and against N such steps + save +
    restore + N eager ones.  ``argv``: the driver's flags of the model.
    Returns the largest weight difference of each."""
    n = TRAIN["exact_n"]
    args = aircraft.parse_args(list(argv))
    device = torch.device("cuda")
    loader = iter(BatchLoader(synthetic_planes(128, seed=0), PATH["batch"],
                              samples=PATH["samples"], seed=0, device=device))
    batches = torch.stack([next(loader) for _ in range(2 * n)])

    def fresh(k=1):
        model, process = aircraft.build(args, device)
        opt = make_optimizer(model.named_parameters(), args.lr)
        state = TrainState(model, opt, torch.Generator(device=device).manual_seed(5))
        return state, make_dp_train_step(aircraft.make_loss_fn(model, process), model, opt,
                                         steps_per_call=k)

    def run(state, step, xs, k=1):
        for i in range(0, len(xs), k):
            state, _ = step(state, xs[i] if k == 1 else xs[i : i + k])
        return state

    def restored(state, name):
        save_checkpoint(os.path.join(tmp, name), state)
        out, step = fresh()
        out = restore_checkpoint(os.path.join(tmp, name), out)
        assert out.step == n, out.step
        return out, step

    def diff(a, b):
        pa, pb = a.model.state_dict(), b.model.state_dict()
        return max(float((pa[k] - pb[k]).abs().max()) for k in pa)

    full = run(*fresh(), batches)
    resumed = run(*restored(run(*fresh(), batches[:n]), "exact"), batches[n:])
    graphed = run(*fresh(5), batches, k=5)
    graphed_half = run(*fresh(5), batches[:n], k=5)
    graphed_resumed = run(*restored(graphed_half, "exact_graphed"), batches[n:])
    sync()
    diffs = {"resume": diff(full, resumed), "captured": diff(full, graphed),
             "captured_then_resume": diff(full, graphed_resumed)}
    emit("exact_resume", argv=list(argv), n=n, max_abs_diff=diffs)
    if any(d != 0.0 for d in diffs.values()):
        raise AssertionError(f"{argv}: weights differ from 2N eager steps: {diffs}")


AIRCRAFT_ARGV = ["--dim", str(PATH["dim"]), "--heads", str(PATH["heads"]), "--layers", str(PATH["layers"]),
                 "--batch", str(PATH["batch"]), "--samples", str(PATH["samples"]),
                 "--timesteps", str(PATH["timesteps"])]


def phase_aircraft_train(tmp: str) -> None:
    """Aircraft training at full width through ``aircraft.main``: timed
    variants, a falling loss and its resume, the exact resumes, ``--test``
    on the checkpoint and Heun-50 on the trained weights."""
    steps = TRAIN["warmup"] + TRAIN["timed"]
    base = ["--so3"] + AIRCRAFT_ARGV
    variants = [("fp32", []), ("bf16", ["--bf16"]), ("fused", ["--opt-impl", "fused"]),
                ("k8", ["--steps-per-call", "8"]),
                ("bf16_k8", ["--bf16", "--steps-per-call", "8"])]
    device = torch.device("cuda")
    proj = aircraft_proj(device)
    fwd_ms = forward_ms(PlaneNet(dim=PATH["dim"], heads=PATH["heads"], layers=PATH["layers"]).to(device).eval(),
                        proj)
    for name, extra in variants:
        ckpt, log = os.path.join(tmp, name), os.path.join(tmp, f"{name}.jsonl")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = aircraft.main(base + extra + [
            "--steps", str(steps), "--print-every", str(TRAIN["print_every"]),
            "--ckpt", ckpt, "--log", log])
        sync()
        seconds = time.perf_counter() - t0
        rows = read_jsonl(log)
        sps = rows[-1]["steps_per_sec"]
        emit("aircraft_train", variant=name, steps=steps, timed_steps=TRAIN["timed"],
             ms_per_step=1e3 / sps, steps_per_sec=sps, forward_ms=fwd_ms,
             forward_share=fwd_ms * sps / 1e3, loss_first=rows[0]["loss"],
             loss_last=rows[-1]["loss"], test_loss=rows[-1]["test_loss"],
             peak_memory_bytes=torch.cuda.max_memory_allocated(), seconds=seconds,
             logged_steps=[r["step"] for r in rows])
        if not all(np.isfinite(r["loss"]) and np.isfinite(r["test_loss"]) for r in rows):
            raise AssertionError(f"aircraft_train {name}: a loss is not finite: {rows}")
        if state.step != steps or rows[-1]["step"] != steps:
            raise AssertionError(f"aircraft_train {name}: step {state.step}, wanted {steps}")
        if latest_step(ckpt) != steps:
            raise AssertionError(f"aircraft_train {name}: no checkpoint at step {steps}")

    # the loss falls; a resume continues from the stored step
    n, more = TRAIN["fall_steps"], TRAIN["fall_steps"] + TRAIN["resume_more"]
    rows, ckpt, log = falling_run("aircraft_train", aircraft.main, base + ["--ckpt-every", "100"], tmp, n)
    files = sorted(os.listdir(ckpt))
    state, _ = run_captured(aircraft.main, base + ["--ckpt-every", "100", "--print-every", "1", "--ckpt", ckpt,
                                                   "--log", log, "--steps", str(more), "--resume"])
    resumed = read_jsonl(log)[len(rows):]
    emit("aircraft_train", run="resume", checkpoints=files, resumed_first_step=resumed[0]["step"],
         resumed_last_step=state.step)
    if not all(np.isfinite(r["loss"]) for r in resumed):
        raise AssertionError("aircraft_train: non-finite loss rows after the resume")
    if files != [f"step_{k:08d}.pt" for k in sorted({*range(100, n + 1, 100), n})[-3:]]:
        raise AssertionError(f"aircraft_train: checkpoints {files}")
    if (resumed[0]["step"], state.step, latest_step(ckpt)) != (n + 1, more, more):
        raise AssertionError(f"aircraft_train: resume ran {resumed[0]['step']}..{state.step}")

    exact_resume_check(tmp)
    aircraft_test("aircraft_train", base + ["--ckpt", ckpt], PATH["batch"])

    # the Heun sampler on the trained weights runs the IGSO(3) kernel
    model, process = aircraft.build(aircraft.parse_args(base), device)
    if not load_eval_weights(model.eval(), ckpt, device):
        raise AssertionError("aircraft_train: no weights to sample from")
    before = obs.counter("ops.igso3.launches")
    t0 = time.perf_counter()
    with torch.inference_mode():
        rots = process.pf_sample_loop(model, torch.Generator(device=device).manual_seed(3),
                                      (PATH["batch"],), PATH["heun_steps"], proj, method="heun")
    sync()
    heun = obs.counter("ops.igso3.launches") - before
    emit("aircraft_train", run="pf_heun_on_trained", seconds=time.perf_counter() - t0,
         launches=heun, median_angle=float(rotation_angle(rots).median()),
         **check_rotations("pf_heun_on_trained", rots))
    if heun != 2 * PATH["heun_steps"]:
        raise AssertionError(f"Heun on the trained weights: {heun} IGSO(3) launches")


def phase_bingham_train(tmp: str) -> None:
    """experiments/bingham.py training on the "lcr" preset with the online MMD
    curve, then --test on its checkpoint."""
    steps, every = TRAIN["bingham_steps"], TRAIN["bingham_mmd_every"]
    ckpt, log = os.path.join(tmp, "ck"), os.path.join(tmp, "log.jsonl")
    t0 = time.perf_counter()
    curve = bingham.main([BINGHAM_COV, "--steps", str(steps), "--mmd-every", str(every),
                          "--print-every", str(TRAIN["bingham_print_every"]),
                          "--out-dir", tmp, "--ckpt", ckpt, "--log", log])[BINGHAM_COV]
    sync()
    seconds = time.perf_counter() - t0
    train_launches = obs.counter("ops.mmd.launches")
    rows = read_jsonl(log)
    # steps/s up to the first evaluation: later rows' clock includes it
    clean = [r for r in rows if r["step"] <= curve[0]["step"]][-1]
    emit("bingham_train", steps=steps, seconds=seconds, steps_per_sec=clean["steps_per_sec"],
         ms_per_step=1e3 / clean["steps_per_sec"], steps_per_sec_at_step=clean["step"],
         loss_first=rows[0]["loss"], loss_last=rows[-1]["loss"], curve=curve,
         gaussian_kernel_sum_launches=train_launches,
         files=sorted(f for f in os.listdir(tmp) if f.endswith(".json")))
    with open(os.path.join(tmp, f"torch_bingham_mmd_curve_{BINGHAM_COV}.json")) as f:
        stored = json.load(f)
    if stored != curve or len(curve) != 2 or curve[-1]["step"] != steps:
        raise AssertionError(f"bingham_train: curve {curve}, file {stored}")
    if not all(np.isfinite(c["mmd"]) for c in curve):
        raise AssertionError(f"bingham_train: MMD not finite: {curve}")
    if train_launches != 6:
        raise AssertionError(f"bingham_train: {train_launches} MMD kernel launches, not 6")
    if not all(np.isfinite(r["loss"]) for r in rows) or latest_step(ckpt) != steps:
        raise AssertionError("bingham_train: non-finite loss or no final checkpoint")
    recs, _ = evaluate(bingham.main, [BINGHAM_COV, "--test", "--out-dir", tmp, "--ckpt", ckpt])
    rec = recs[BINGHAM_COV][0]
    emit("bingham_train", run="test_on_checkpoint", mmd=rec["mmd"], passes=rec["passes"],
         accept_threshold=rec["accept_threshold"], seconds=rec["sample_seconds"],
         launches=rec["launches"])
    if not np.isfinite(rec["mmd"]):
        raise AssertionError("bingham_train: --test gave a non-finite MMD")


def protein_init(tmp: str, se3: bool, name: str) -> str:
    """ProtNet at the headline width (seeded init): the parameter count, the
    forward's output and ms in float32 and bf16; then the init with its
    output layer scaled by PROTEIN_HEAD_SCALE written to ``tmp`` as a state
    dict, whose path is returned."""
    device = torch.device("cuda")
    torch.manual_seed(0)
    with torch.device(device):
        model = ProtNet(dim=PROTEIN["dim"], heads=PROTEIN["heads"], t_depth=PROTEIN["t_depth"],
                        c_depth=PROTEIN["c_depth"], se3=se3, frame_pool=True,
                        cross_depth=PROTEIN["cross_depth"], rel_frame=True, equiv_head=True).eval()
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != PROTEIN["params"]:
        raise AssertionError(f"ProtNet(se3={se3}) at the headline width has {n_params} parameters")
    rng = np.random.default_rng(0)
    batch = to_device(pad_prot_batch([synthetic_prot_pair(rng, PROTEIN["receptor"], PROTEIN["ligand"])
                                      for _ in range(PROTEIN["batch"])]), device)
    pose = AffineT.identity((PROTEIN["batch"],), device=device) if se3 else torch.zeros(
        PROTEIN["batch"], 6, device=device)
    x_in = ProtProjection(batch, se3=se3)(pose)
    t_in = torch.full((PROTEIN["batch"],), 500, device=device)
    flops = protein_flops(PROTEIN["dim"], PROTEIN["t_depth"], PROTEIN["c_depth"],
                          PROTEIN["batch"], PROTEIN["receptor"], PROTEIN["ligand"],
                          PROTEIN["cross_depth"], frame_pool=True, rel_frame=True,
                          equiv_head=True)
    fwd = {}
    with torch.inference_mode():
        for prec, bf16 in (("fp32", False), ("bf16", True)):
            model.bf16 = bf16
            out = model(x_in, t_in)
            if not se3 and (out.shape != (PROTEIN["batch"], 6) or not torch.isfinite(out).all()):
                raise AssertionError(f"{name}: forward {prec} gave {out.shape}")
            ms = time_cuda(lambda: model(x_in, t_in), 10, warmup=3)
            fwd.update({f"forward_ms_{prec}": ms, f"forward_tflops_{prec}": flops / ms / 1e9})
    emit(name, run="forward", forward_gflop=flops / 1e9, **fwd, **PROTEIN)
    with torch.no_grad():
        model.head_out.weight.mul_(PROTEIN_HEAD_SCALE)
        model.head_out.bias.mul_(PROTEIN_HEAD_SCALE)
    weights = os.path.join(tmp, f"{name}_init_head_scaled.pt")
    torch.save(model.state_dict(), weights)
    del model, x_in
    torch.cuda.empty_cache()
    return weights


def protein_record(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k not in ("angles", "shifts")}


def phase_protein_path(tmp: str) -> None:
    """The protein docking path at the headline width: the forward, then
    experiments/protein.py --test --bf16 with each sampler row on the
    seeded init (its output layer scaled), records into ``tmp``."""
    weights = protein_init(tmp, True, "protein_setup")
    for name, flags, per_pose, evals, launches in PROTEIN_ROWS:
        with mock.patch.object(protein, "SAMPLES", per_pose):
            rec, _ = evaluate(protein.main, PROTEIN_ARGV + flags + ["--test", "--ckpt", weights, "--out-dir", tmp])
        emit("protein_run", sampler=name, seconds=rec["sample_seconds"],
             model_evals=rec["model_evals"], launches=rec["launches"], poses=rec["poses"],
             samples_per_pose=per_pose, sweeps=rec["sweeps"], orth_err=rec["orth_err"],
             det_err=rec["det_err"], angle_p50=float(np.median(rec["angles"])),
             shift_p50=float(np.median(rec["shifts"])))
        if evals is None:  # Picard: one batched call a sweep, then the final estimate
            evals = max(rec["sweeps"]) + 1
        ok = (rec["finite"] and rec["orth_err"] < 1e-4 and rec["det_err"] < 1e-4
              and rec["poses"] == PROTEIN["batch"] * per_pose
              and rec["model_evals"] == evals and rec["launches"] == launches)
        if not ok:
            raise AssertionError(f"protein row {name}: {protein_record(rec)}")


def protein_exact_resume(tmp: str) -> None:
    """At the headline width with the production flags (bf16, fused Adam with
    bf16 moments, K = 8: one CUDA graph replayed a step): 2N replayed steps
    against N + save + restore + N, from the same init and batches."""
    n = PROTEIN_TRAIN["exact_n"]
    args = protein.parse_args(PROTEIN_ARGV + ["--opt-impl", "fused", "--opt-state-dtype",
                                              "bf16", "--steps-per-call", str(n)])
    device = torch.device("cuda")
    pairs = protein.load_pairs(args)
    gen = protein.batch_stream(pairs, args, np.random.default_rng(0))
    groups = [to_device(protein.stack_batches([next(gen) for _ in range(n)]), device)
              for _ in range(2)]

    def fresh():
        model, process = protein.build(args, device)
        opt = make_optimizer(model.named_parameters(), args.lr, impl="fused", state_dtype="bf16")
        state = TrainState(model, opt, torch.Generator(device=device).manual_seed(5))
        return state, make_dp_train_step(protein.make_loss_fn(model, process), model, opt,
                                         steps_per_call=n)

    full, step = fresh()
    for g in groups:
        full, _ = step(full, g)
    half, step = fresh()
    half, _ = step(half, groups[0])
    save_checkpoint(os.path.join(tmp, "exact"), half)
    del half, step
    resumed, step = fresh()
    resumed = restore_checkpoint(os.path.join(tmp, "exact"), resumed)
    assert resumed.step == n, resumed.step
    resumed, _ = step(resumed, groups[1])
    sync()
    pa, pb = full.model.state_dict(), resumed.model.state_dict()
    diff = max(float((pa[k] - pb[k]).abs().max()) for k in pa)
    emit("protein_train", run="exact_resume", n=n, max_abs_diff=diff)
    if diff != 0.0:
        raise AssertionError(f"protein_train: resumed weights differ by {diff}")


PRODUCTION = ["--opt-impl", "fused", "--opt-state-dtype", "bf16", "--steps-per-call", "8"]


def timed_protein_run(name: str, argv: list, tmp: str, steps: int) -> None:
    """``protein.main(argv)`` for ``steps`` steps, timed by its last logged
    row; the step, the checkpoint and the loss checked."""
    ckpt, log = os.path.join(tmp, name), os.path.join(tmp, f"{name}.jsonl")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = protein.main(argv + ["--steps", str(steps), "--print-every", str(steps), "--ckpt", ckpt,
                                 "--log", log])
    seconds = time.perf_counter() - t0
    rows = read_jsonl(log)
    sps = rows[-1]["steps_per_sec"]
    emit(name, steps=steps, timed_steps=PROTEIN_TRAIN["timed"], ms_per_step=1e3 / sps, steps_per_sec=sps,
         loss_last=rows[-1]["loss"], grad_norm=rows[-1]["grad_norm"],
         peak_memory_bytes=torch.cuda.max_memory_allocated(), seconds=seconds)
    if state.step != steps or latest_step(ckpt) != steps or not np.isfinite(rows[-1]["loss"]):
        raise AssertionError(f"{name}: step {state.step}, rows {rows}")
    del state
    shutil.rmtree(ckpt)


def phase_protein_train(tmp: str) -> None:
    """Protein training at the headline width through ``protein.main``:
    timed variants (warm-up: 10 steps at K = 1, two calls at K = 8), a
    falling loss (a row a call of 8) and ``--test`` on its checkpoint, the
    replayed resume, two epochs of ``--epoch-accum``."""
    timed = PROTEIN_TRAIN["timed"]
    timed_protein_run("protein_train_bf16", PROTEIN_ARGV + ["--steps-per-call", "1"], tmp, 10 + timed)
    timed_protein_run("protein_train_bf16_fused_bf16moments_k8", PROTEIN_ARGV + PRODUCTION, tmp, 16 + timed)

    n = PROTEIN_TRAIN["fall_steps"]
    _, ckpt, _ = falling_run("protein_train", protein.main, PROTEIN_ARGV + PRODUCTION, tmp, n, window=5,
                             calls=n // 8)
    with mock.patch.object(protein, "SAMPLES", 1):
        rec, _ = evaluate(protein.main, PROTEIN_ARGV + ["--test", "--sampler", "ddim", "--ckpt", ckpt,
                                                        "--out-dir", tmp])
    emit("protein_train", run="test_on_checkpoint", sampler="ddim_50",
         seconds=rec["sample_seconds"], poses=rec["poses"],
         angle_p50=float(np.median(rec["angles"])), shift_p50=float(np.median(rec["shifts"])))
    if not rec["finite"] or rec["orth_err"] >= 1e-4:
        raise AssertionError(f"protein_train --test: {protein_record(rec)}")
    shutil.rmtree(ckpt)

    protein_exact_resume(tmp)

    epochs = PROTEIN_TRAIN["accum_epochs"]
    ckpt, log = os.path.join(tmp, "accum"), os.path.join(tmp, "accum.jsonl")
    run_captured(protein.main, PROTEIN_ARGV + [
        "--epoch-accum", "--steps", str(epochs), "--ckpt", ckpt, "--log", log])
    rows = read_jsonl(log)
    emit("protein_train", run="epoch_accum", epochs=epochs, optimizer_steps=latest_step(ckpt),
         losses=[r["loss"] for r in rows])
    # 16 pairs in batches of 16: one batch an epoch, one optimizer step an epoch
    if latest_step(ckpt) != epochs or len(rows) != epochs or \
            not all(np.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"protein_train: --epoch-accum rows {rows}")


def phase_euler_aircraft(tmp: str) -> None:
    """The aircraft Euler arm at full width through ``aircraft.main``: timed
    ``--bf16 --steps-per-call 8`` steps, a fp32 run whose loss must fall,
    and ``--test --euler-init haar`` on its checkpoint."""
    steps = TRAIN["warmup"] + TRAIN["timed"]
    log = os.path.join(tmp, "euler_k8.jsonl")
    torch.cuda.reset_peak_memory_stats()
    state = aircraft.main(AIRCRAFT_ARGV + ["--bf16", "--steps-per-call", "8", "--steps", str(steps),
                                           "--print-every", str(TRAIN["print_every"]), "--ckpt",
                                           os.path.join(tmp, "euler_k8"), "--log", log])
    rows = read_jsonl(log)
    sps = rows[-1]["steps_per_sec"]
    emit("euler_aircraft", variant="bf16_k8", steps=steps, timed_steps=TRAIN["timed"],
         ms_per_step=1e3 / sps, steps_per_sec=sps, loss_last=rows[-1]["loss"],
         test_loss=rows[-1]["test_loss"], peak_memory_bytes=torch.cuda.max_memory_allocated())
    if state.step != steps or not all(np.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"euler_aircraft: step {state.step}, rows {rows}")
    _, ckpt, _ = falling_run("euler_aircraft", aircraft.main, AIRCRAFT_ARGV, tmp, EULER["fall_steps"])
    out = aircraft_test("euler_aircraft", AIRCRAFT_ARGV + ["--euler-init", "haar", "--ckpt", ckpt],
                        EULER["test_shapes"])
    if "(eul)" not in out:
        raise AssertionError("euler_aircraft: --test did not run the Euler arm")


def phase_euler_protein(tmp: str) -> None:
    """The protein Euler arm (--se3 off) at the headline width: the forward
    in float32 and bf16, 16 + 96 steps with the production flags, then
    ``--test`` with the 1000-step ancestral chain (one sample a pose, the
    seeded init with its output layer scaled); rotations gated on SO(3),
    shifts on finiteness."""
    weights = protein_init(tmp, False, "euler_protein")
    timed_protein_run("euler_protein_bf16_fused_bf16moments_k8", PROTEIN_EULER_ARGV + PRODUCTION, tmp,
                      16 + PROTEIN_TRAIN["timed"])
    with mock.patch.object(protein, "SAMPLES", 1):
        rec, _ = evaluate(protein.main, PROTEIN_EULER_ARGV + ["--test", "--ckpt", weights, "--out-dir", tmp])
    emit("euler_protein", run="test_ancestral_1000", seconds=rec["sample_seconds"],
         model_evals=rec["model_evals"], poses=rec["poses"], finite=rec["finite"],
         orth_err=rec["orth_err"], det_err=rec["det_err"],
         angle_p50=float(np.median(rec["angles"])), shift_p50=float(np.median(rec["shifts"])),
         shift_max=float(np.max(rec["shifts"])))
    ok = (rec["arm"] == "eul" and rec["finite"] and rec["orth_err"] < 1e-4
          and rec["det_err"] < 1e-4 and rec["poses"] == PROTEIN["batch"]
          and rec["model_evals"] == PROTEIN["timesteps"])
    if not ok:
        raise AssertionError(f"euler_protein --test: {protein_record(rec)}")


def phase_so3_toy(tmp: str) -> None:
    """experiments/so3_toy.py: training at K = 16 (one CUDA graph replayed a
    step), then --test with the ancestral, DDIM-50 and probability-flow-50
    samplers over 512 chains."""
    ckpt, log, out = (os.path.join(tmp, "toy"), os.path.join(tmp, "toy.jsonl"),
                      os.path.join(tmp, "toy_out"))
    steps = SUITES["toy_steps"]
    t0 = time.perf_counter()
    so3_toy.main(["--steps", str(steps), "--steps-per-call", str(SUITES["toy_k"]),
                  "--print-every", "400", "--ckpt", ckpt, "--log", log])
    rows = read_jsonl(log)
    emit("so3_toy", run="train", steps=steps, seconds=time.perf_counter() - t0,
         steps_per_sec=rows[-1]["steps_per_sec"], loss_first=rows[0]["loss"],
         loss_last=rows[-1]["loss"])
    if latest_step(ckpt) != steps or not all(np.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"so3_toy: rows {rows}, checkpoint {latest_step(ckpt)}")
    for sampler in ("ancestral", "ddim", "pf"):
        rec, _ = evaluate(so3_toy.main, ["--test", "--sampler", sampler, "--eval-batch",
                                         str(SUITES["eval_batch"]), "--ckpt", ckpt, "--out-dir", out])
        emit("so3_toy", run="test", sampler=sampler, seconds=rec["sample_seconds"],
             model_evals=rec["model_evals"], launches=rec["launches"],
             percentiles=rec["percentiles"])
        if not rec["finite"] or rec["count"] != SUITES["eval_batch"] or rec["launches"] != 0:
            raise AssertionError(f"so3_toy --test {sampler}: {rec['percentiles']}")


def phase_lock(tmp: str) -> None:
    """experiments/lock.py, both arms: eager steps (the non-finite skip
    waits for the device), then --test over 512 chains."""
    out = os.path.join(tmp, "lock_out")
    steps = SUITES["lock_steps"]
    for param in ("so3", "euler"):
        ckpt, log = os.path.join(tmp, f"lock_{param}"), os.path.join(tmp, f"lock_{param}.jsonl")
        t0 = time.perf_counter()
        lock.main(["--param", param, "--steps", str(steps), "--print-every", "200",
                   "--ckpt", ckpt, "--log", log])
        rows = read_jsonl(log)
        emit("lock", param=param, run="train", steps=steps, seconds=time.perf_counter() - t0,
             steps_per_sec=rows[-1]["steps_per_sec"], loss_first=rows[0]["loss"],
             loss_last=rows[-1]["loss"])
        if latest_step(ckpt) != steps or not all(np.isfinite(r["loss"]) for r in rows):
            raise AssertionError(f"lock {param}: rows {rows}")
        rec, _ = evaluate(lock.main, ["--param", param, "--test", "--eval-batch", str(SUITES["eval_batch"]),
                                      "--ckpt", ckpt, "--out-dir", out])
        emit("lock", param=param, run="test", seconds=rec["sample_seconds"],
             axis_y_mean=rec["axis_y_mean"], angle_mean=rec["angle_mean"],
             in_range=rec["in_range"], count=rec["count"])
        if not rec["finite"] or rec["count"] != SUITES["eval_batch"]:
            raise AssertionError(f"lock --test {param}: {rec}")
    files = sorted(os.listdir(out))
    if files != ["torch_lock_euler.json", "torch_lock_samples_euler.npy",
                 "torch_lock_samples_so3.npy", "torch_lock_so3.json"]:
        raise AssertionError(f"lock records: {files}")


def jigsaw_determinism() -> dict:
    """Two runs of ``det_steps`` eager train steps from one init, with cuDNN's
    deterministic algorithms off and on: whether the two runs end on the
    same bits, and the ms a step (CUDA events, after 3 warm-up steps)."""
    device = torch.device("cuda")
    args = jigsaw.parse_args(["--batch", str(JIGSAW["batch"])])
    rows = torch.from_numpy(puzzle_rows(jigsaw.step_seeds(0, 0, JIGSAW["det_steps"]))).to(device)
    out = {}
    before = torch.backends.cudnn.deterministic
    try:
        for det in (False, True):
            torch.backends.cudnn.deterministic = det
            finals, ms = [], []
            for _ in range(2):
                model, process = jigsaw.build(args, device)
                opt = make_optimizer(model.named_parameters(), args.lr)
                state = TrainState(model, opt, torch.Generator(device=device).manual_seed(0))
                step = make_dp_train_step(jigsaw.make_loss_fn(model, process, args.batch,
                                                              args.size), model, opt)
                for i in range(3):
                    step(state, rows[i])
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for i in range(3, JIGSAW["det_steps"]):
                    step(state, rows[i])
                end.record()
                sync()
                ms.append(start.elapsed_time(end) / (JIGSAW["det_steps"] - 3))
                finals.append([p.detach().clone() for p in model.parameters()])
            key = "deterministic" if det else "default"
            out[f"{key}_same_bits"] = all(torch.equal(a, b) for a, b in zip(*finals))
            out[f"{key}_max_diff"] = max(float((a - b).abs().max()) for a, b in zip(*finals))
            out[f"{key}_ms"] = ms
    finally:
        torch.backends.cudnn.deterministic = before
    return out


def phase_jigsaw(tmp: str) -> None:
    """experiments/jigsaw.py at full width: timed eager steps (ms, TFLOP/s
    against ``coordconv_flops``, peak memory), a run whose loss must fall,
    cuDNN determinism and its cost, then ``--test`` (the 1000-step chain
    over 64 samples) on the falling run's checkpoint."""
    base = ["--batch", str(JIGSAW["batch"]), "--size", str(JIGSAW["size"]), "--timesteps",
            str(JIGSAW["timesteps"])]
    steps = JIGSAW["warmup"] + JIGSAW["timed"]
    log = os.path.join(tmp, "jigsaw_timed.jsonl")
    torch.cuda.reset_peak_memory_stats()
    state = jigsaw.main(base + ["--steps", str(steps), "--print-every", str(steps), "--ckpt",
                                os.path.join(tmp, "jigsaw_timed"), "--log", log])
    rows = read_jsonl(log)
    sps = rows[-1]["steps_per_sec"]
    _, step_flops = coordconv_flops(JIGSAW["size"])
    step_flops *= JIGSAW["batch"]
    emit("jigsaw", run="timed", steps=steps, timed_steps=JIGSAW["timed"], ms_per_step=1e3 / sps,
         steps_per_sec=sps, step_tflop=step_flops / 1e12,
         tflops_per_s=step_flops * sps / 1e12, peak_memory_bytes=torch.cuda.max_memory_allocated(),
         loss_last=rows[-1]["loss"])
    if state.step != steps or not np.isfinite(rows[-1]["loss"]):
        raise AssertionError(f"jigsaw: step {state.step}, rows {rows}")

    _, ckpt, _ = falling_run("jigsaw", jigsaw.main, base, tmp, JIGSAW["fall_steps"])
    det = jigsaw_determinism()
    emit("jigsaw", run="cudnn_determinism", steps=JIGSAW["det_steps"], **det)
    if not det["deterministic_same_bits"]:
        raise AssertionError(f"jigsaw: deterministic cuDNN steps differ run to run: {det}")

    rec, _ = evaluate(jigsaw.main, base + ["--test", "--eval-batch", str(JIGSAW["eval_batch"]), "--ckpt", ckpt,
                                           "--out-dir", os.path.join(tmp, "jigsaw_out")])
    emit("jigsaw", run="test", seconds=rec["sample_seconds"], model_evals=rec["model_evals"],
         count=rec["count"], finite=rec["finite"], px=rec["px"], diverged=rec["diverged"],
         trained_steps=JIGSAW["fall_steps"])
    if not rec["finite"] or rec["count"] != JIGSAW["eval_batch"] or rec["model_evals"] != JIGSAW["timesteps"]:
        raise AssertionError(f"jigsaw --test: {rec['px']}")


def phase_diagnostics(tmp: str) -> None:
    """The compute-side diagnostics on the card: ``se3-path`` at its defaults
    (finite shifts, every pose on SO(3)), ``grad_check`` at its defaults (its
    loss must halve), and ``IGSO3xR3.log_prob`` over 50,000 poses (kernel 1,
    one launch for the pose and one for its rotation alone); no figure."""
    t0 = time.perf_counter()
    rots, shifts = diagnostics.main(["se3-path", "--out-dir", tmp])
    seconds = time.perf_counter() - t0
    steps, n = DIAG["se3_steps"], DIAG["se3_samples"]
    r = torch.from_numpy(rots)
    orth = float((r.transpose(-1, -2) @ r - torch.eye(3)).abs().max())
    det = float((torch.linalg.det(r) - 1.0).abs().max())
    emit("diagnostics", run="se3_path", seconds=seconds, steps=steps, samples=n,
         orth_err=orth, det_err=det, shift_abs_max=float(np.abs(shifts).max()),
         shift_std_last=float(shifts[-1].std()))
    if rots.shape != (steps + 1, n, 3, 3) or shifts.shape != (steps + 1, n, 3) \
            or not np.isfinite(shifts).all() or not (orth < 1e-4 and det < 1e-4):
        raise AssertionError(f"se3-path: {rots.shape} {shifts.shape}, orth {orth}, det {det}")

    t0 = time.perf_counter()
    res, _ = run_captured(grad_check.main, [])
    sync()
    emit("diagnostics", run="grad_check", seconds=time.perf_counter() - t0, **res)
    if res["iters"] != DIAG["grad_iters"] or not res["loss_last"] < 0.5 * res["loss_first"]:
        raise AssertionError(f"grad_check: {res}")

    m = DIAG["log_prob_n"]
    gen = torch.Generator(device="cuda").manual_seed(41)
    eps = torch.rand(m, generator=gen, device="cuda") * 1.2 + 0.05
    mean = AffineT(exp_skewvec(torch.randn(m, 3, generator=gen, device="cuda")),
                   torch.randn(m, 3, generator=gen, device="cuda"))
    dist = IGSO3xR3.create(eps, mean=mean, shift_scale=75.0, device="cuda")
    value = dist.sample(gen)
    launches0 = obs.counter("ops.igso3.launches")
    finite = bool(torch.isfinite(dist.log_prob(value)).all() and torch.isfinite(dist.igso3.log_prob(value.rot)).all())
    launched = obs.counter("ops.igso3.launches") - launches0
    emit("diagnostics", run="igso3xr3_log_prob", n=m, launches=launched, finite=finite)
    if launched != 2 or not finite:
        raise AssertionError(f"IGSO3xR3.log_prob: {launched} launches, finite {finite}")


def moe_eval_loss(model) -> float:
    """The MoE arm's loss (with its aux) on a fixed evaluation set: 128
    validation clouds in batches of 32, t and noise drawn once from a seed;
    what the falling-loss gate compares before and after training (a
    logged row is one batch's loss, too noisy to compare over 208 steps)."""
    device = torch.device("cuda")
    clouds = torch.from_numpy(subsample_points(synthetic_planes(128, seed=1), PATH["samples"],
                                               31)).to(device)
    process = ProjectedSO3Diffusion(PATH["timesteps"], device=device)
    gen = torch.Generator(device=device).manual_seed(9)
    loss_fn = aircraft.make_loss_fn(model, process)
    total = 0.0
    with torch.no_grad():
        for i in range(0, len(clouds), PATH["batch"]):
            t, noise = aircraft.draw_t_noise(process, gen, PATH["batch"])
            total += float(loss_fn(None, (clouds[i:i + PATH["batch"]], t, noise)))
    return total * PATH["batch"] / len(clouds)


def phase_moe_aircraft(tmp: str) -> None:
    """The Switch-MoE aircraft arm at full width through ``aircraft.main``
    (bench.py's moe_train_e4: PlaneNet d512 / h4 / l4 with 4 experts,
    scatter dispatch, batch 32 x 256 points, T = 8,192 tokens a layer,
    C = 2,560): MOE["steps"] replayed ``--bf16 --steps-per-call 8`` steps
    (ms, steps/s, peak memory, the loss on a fixed evaluation set falling
    from the init, expert fractions, the aux on the trained weights), the
    one-hot dispatch timed beside the scatter one, replayed and resumed
    steps against eager ones to the bit, then ``--test`` over 32 shapes."""
    base = ["--so3", "--moe-experts", str(MOE["experts"])] + AIRCRAFT_ARGV
    arm = base + ["--bf16", "--steps-per-call", "8"]
    init, _ = aircraft.build(aircraft.parse_args(arm), torch.device("cuda"))
    loss_init = moe_eval_loss(init)
    ckpt, log = os.path.join(tmp, "moe"), os.path.join(tmp, "moe.jsonl")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, _ = run_captured(aircraft.main, arm + [
        "--steps", str(MOE["steps"]), "--print-every", str(MOE["print_every"]), "--ckpt", ckpt,
        "--log", log])
    sync()
    seconds = time.perf_counter() - t0
    rows = read_jsonl(log)
    sps = rows[-1]["steps_per_sec"]
    first = float(np.mean([r["loss"] for r in rows[:5]]))
    last = float(np.mean([r["loss"] for r in rows[-5:]]))
    model = state.model
    loss_trained = moe_eval_loss(model)
    probe = torch.from_numpy(subsample_points(synthetic_planes(128, seed=1)[: PATH["batch"]],
                                              PATH["samples"], 29)).cuda()
    with torch.no_grad():
        model(probe, torch.full((PATH["batch"],), 500, device="cuda"))
        aux = float(model.moe_aux())
    emit("moe_aircraft", variant="bf16_k8_scatter", steps=MOE["steps"], ms_per_step=1e3 / sps,
         steps_per_sec=sps, peak_memory_bytes=torch.cuda.max_memory_allocated(),
         loss_first_5_rows=first, loss_last_5_rows=last, eval_loss_init=loss_init,
         eval_loss_trained=loss_trained, test_loss=rows[-1]["test_loss"],
         aux_on_trained=aux, expert_fracs=rows[-1]["expert_fracs"],
         expert_frac_min=rows[-1]["expert_frac_min"], expert_frac_max=rows[-1]["expert_frac_max"],
         tokens_per_layer=PATH["batch"] * PATH["samples"],
         capacity=model.encoder.layers[0].moe.capacity(PATH["batch"] * PATH["samples"]),
         seconds=seconds)
    if state.step != MOE["steps"] or not all(np.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"moe_aircraft: step {state.step}, rows {rows}")
    if not (loss_trained < loss_init and np.isfinite(aux)):
        raise AssertionError(f"moe_aircraft: eval loss {loss_init} -> {loss_trained}, aux {aux}")

    timing = {}
    steps = TRAIN["warmup"] + TRAIN["timed"]
    for dispatch in ("scatter", "onehot", "scatter", "onehot"):
        log = os.path.join(tmp, f"moe_{dispatch}_{len(timing)}.jsonl")
        torch.cuda.reset_peak_memory_stats()
        aircraft.main(arm + ["--moe-dispatch", dispatch, "--steps", str(steps), "--print-every",
                             str(TRAIN["print_every"]), "--ckpt", os.path.join(tmp, "moe_t"),
                             "--log", log])
        timing.setdefault(dispatch, []).append(
            (1e3 / read_jsonl(log)[-1]["steps_per_sec"], torch.cuda.max_memory_allocated()))
    ms = {d: [m for m, _ in v] for d, v in timing.items()}
    emit("moe_aircraft", run="dispatch_timing", steps=steps, timed_steps=TRAIN["timed"],
         scatter_ms=ms["scatter"], onehot_ms=ms["onehot"],
         onehot_over_scatter=float(np.mean(ms["onehot"]) / np.mean(ms["scatter"])),
         scatter_peak_bytes=[b for _, b in timing["scatter"]],
         onehot_peak_bytes=[b for _, b in timing["onehot"]])

    exact_resume_check(tmp, ["--so3", "--bf16", "--moe-experts", str(MOE["experts"])])
    aircraft_test("moe_aircraft", base + ["--bf16", "--ckpt", ckpt], PATH["batch"])


def trunk_aircraft(tmp: str, name: str, spec: dict) -> None:
    """PlaneNet with a trunk of ``models/deepseek_v2.py`` or
    ``models/kimi_linear.py`` at its cell's size (``spec``: the trunk, 8
    of its routed experts held, bf16, fused Adam at lr 3e-4) through
    ``aircraft.main``: ``spec["steps"]`` replayed K = 8 steps (ms, peak
    memory, finite losses, the expert fractions), then one call of a fresh
    K = 8 step under the profiler: Adam's kernel once a step, the row-pass
    kernels six a MoE layer a step, the attention kernels three an MLA
    layer a step, the device kernels a step, the held experts' rows and
    their even share from the device counters, and the kernels a KDA
    mixer's forward adds to the graph."""
    from diffusion_extensions_tpu_torch.models.deepseek_v2 import MLA

    arm = ["--so3", "--trunk", spec["trunk"], "--bf16", "--batch", str(spec["batch"]), "--samples",
           str(spec["samples"]), "--timesteps", "1000", "--opt-impl", "fused", "--lr", "3e-4",
           "--steps-per-call", "8"]
    ckpt, log = os.path.join(tmp, name), os.path.join(tmp, name + ".jsonl")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, out = run_captured(aircraft.main, arm + ["--steps", str(spec["steps"]), "--print-every",
                                               str(spec["print_every"]), "--ckpt", ckpt, "--log", log])
    sync()
    seconds = time.perf_counter() - t0
    rows = read_jsonl(log)
    params = sum(p.numel() for p in state.model.parameters())
    emit(name, variant="bf16_k8", steps=spec["steps"], params=params,
         ms_per_step=1e3 / rows[-1]["steps_per_sec"], peak_memory_bytes=torch.cuda.max_memory_allocated(),
         losses=[r["loss"] for r in rows], test_loss=rows[-1]["test_loss"],
         expert_frac_max=rows[-1]["expert_frac_max"], seconds=seconds, launches=kernel_launches())
    if params != spec["params"] or state.step != spec["steps"] \
            or not all(np.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"{name}: {params} parameters, step {state.step}, rows {rows}")
    del state
    torch.cuda.empty_cache()

    args = aircraft.parse_args(arm)
    model, process = aircraft.build(args, torch.device("cuda"))
    opt = make_optimizer(model.named_parameters(), args.lr, impl="fused")
    step = make_dp_train_step(aircraft.make_loss_fn(model, process), model, opt, steps_per_call=8)
    st = TrainState(model, opt, torch.Generator(device="cuda").manual_seed(1))
    batches = torch.from_numpy(subsample_points(synthetic_planes(8 * spec["batch"], seed=3), spec["samples"], 5))
    batches = batches.reshape(8, spec["batch"], spec["samples"], 3).cuda()
    st, _ = step(st, batches)  # the eager step, the capture, the replays
    sync()
    before = obs.snapshot()["counters"]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        st, m = step(st, batches)
        sync()
    after = obs.snapshot()["counters"]
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
             and not e.name.startswith("dxt::")]
    adam_a_step = sum("adam_update" in n for n in names) / 8
    moe_rows_a_step = sum(any(f"{k}<" in n for k in MOE_ROWS_KERNELS) for n in names) / 8
    mla_a_step = sum(any(f"{k}<" in n for k in MLA_KERNELS) for n in names) / 8
    moe = model.encoder.moe_layers()
    routing = moe[0].cfg
    mla_layers = sum(isinstance(layer.self_attn, MLA) for layer in model.encoder.layers)
    rows = after["moe.rows"] - before["moe.rows"]
    expected = (len(moe) * spec["batch"] * spec["samples"]
                * routing.num_experts_per_tok * routing.experts_held / routing.n_routed_experts)
    emit(name, run="profiled_call", adam_launches_a_step=adam_a_step,
         moe_rows_kernels_a_step=moe_rows_a_step, mla_attention_kernels_a_step=mla_a_step,
         device_ops_a_step=len(names) / 8, graph_kernels=after.get("train.graph_kernels"),
         moe_kernels_per_layer=after["moe.graph_kernels"] / after["moe.captures"],
         kda_kernels_per_layer=after["kda.graph_kernels"] / after["kda.captures"] if after.get("kda.captures")
         else None,
         held_rows_a_step=rows / 8, expected_rows_a_step=expected,
         held_load_share=rows / (after["moe.rows_even"] - before["moe.rows_even"]),
         load_max_over_mean=(after["moe.rows_max"] - before["moe.rows_max"]) * routing.experts_held / rows,
         loss=float(m["loss"]))
    if adam_a_step != 1 or not np.isfinite(float(m["loss"])):
        raise AssertionError(f"{name}: adam_update {adam_a_step} a step, loss {float(m['loss'])}")
    if moe_rows_a_step != 6 * len(moe):
        raise AssertionError(f"{name}: {moe_rows_a_step} row-pass kernels a step, "
                             f"not 6 in each of {len(moe)} MoE layers")
    if mla_a_step != 3 * mla_layers:
        raise AssertionError(f"{name}: {mla_a_step} attention kernels a step, "
                             f"not 3 in each of {mla_layers} MLA layers")


def phase_dsv2_aircraft(tmp: str) -> None:
    """The DeepSeek-V2 trunk at the dsv2lite-aircraft-train cell's size
    (DSV2: 1 dense + 4 MoE layers at DeepSeek-V2-Lite's widths, 8 of 64
    experts held, 64 clouds x 256 points): ``trunk_aircraft``."""
    trunk_aircraft(tmp, "dsv2_aircraft", DSV2)


def phase_kimi_aircraft(tmp: str) -> None:
    """The Kimi Linear trunk at the kimilinear-aircraft-train cell's size
    (KIMI: KDA + dense, KDA, KDA, MLA, KDA over MoE at Kimi Linear's widths,
    8 of 256 experts held, 16 clouds x 1,024 points): ``trunk_aircraft``."""
    trunk_aircraft(tmp, "kimi_aircraft", KIMI)


def phase_dp_world1(tmp: str) -> None:
    """The multi-process code on the card at world size 1 over NCCL (a
    group made in this process; the card's machine has one GPU):
    DP_WORLD1["steps"] replayed ``--bf16`` K = 8 aircraft steps at full
    width through ``make_dp_train_step(group=...)``, the loss drawing the
    global batch's noise and taking the rank's slice, the all-reduce
    inside the capture: every loss finite (the card test
    ``test_nccl_world_of_one_replays_its_all_reduce`` holds them to the
    bits of the steps without a group); then ``--fsdp`` (FSDP2 over the
    group) for DP_WORLD1["fsdp_steps"] eager fp32 steps through
    ``aircraft.main`` against the plain eager steps, losses within rtol
    1e-5 (both with the numpy loader: the native one's two threads hand out
    batches in the order they finish)."""
    import torch.distributed as dist

    base = ["--so3"] + AIRCRAFT_ARGV
    n = DP_WORLD1["fsdp_steps"]
    logs = {name: os.path.join(tmp, f"{name}.jsonl") for name in ("plain", "fsdp")}
    aircraft.main(base + ["--steps", str(n), "--print-every", "1", "--no-native", "--ckpt",
                          os.path.join(tmp, "plain"), "--log", logs["plain"]])
    device = torch.device("cuda")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        args = aircraft.parse_args(base + ["--bf16"])
        loader = iter(BatchLoader(synthetic_planes(128, seed=0), PATH["batch"],
                                  samples=PATH["samples"], seed=0, device=device))
        batches = torch.stack([next(loader) for _ in range(DP_WORLD1["steps"])])
        model, process = aircraft.build(args, device)
        opt = make_optimizer(model.named_parameters(), args.lr)
        state = TrainState(model, opt, torch.Generator(device=device).manual_seed(5))
        step = make_dp_train_step(aircraft.make_global_loss_fn(model, process, dist.group.WORLD), model, opt,
                                  steps_per_call=8, group=dist.group.WORLD)
        losses = []
        for i in range(0, DP_WORLD1["steps"], 8):
            state, m = step(state, batches[i:i + 8])
            losses.append(float(m["loss"]))
        emit("dp_world1", run="replayed_all_reduce", steps=DP_WORLD1["steps"], k=8, backend=dist.get_backend(),
             world_size=dist.get_world_size(), losses=losses, captures=obs.counter("train.captures"))
        if state.step != DP_WORLD1["steps"] or not all(np.isfinite(losses)):
            raise AssertionError(f"dp_world1: replayed all-reduce steps reached step {state.step}, "
                                 f"losses {losses}")
        del state, step, model, opt
        aircraft.main(base + ["--fsdp", "--steps", str(n), "--print-every", "1", "--no-native",
                              "--ckpt", os.path.join(tmp, "fsdp"), "--log", logs["fsdp"]])
    finally:
        dist.destroy_process_group()
    plain, fsdp = ([r["loss"] for r in read_jsonl(logs[name])] for name in ("plain", "fsdp"))
    rel = max(abs(p - f) / abs(p) for p, f in zip(plain, fsdp))
    emit("dp_world1", run="fsdp", steps=n, loss_plain=plain, loss_fsdp=fsdp, max_rel_err=rel, rtol=1e-5)
    if len(fsdp) != n or not rel < 1e-5:
        raise AssertionError(f"dp_world1: --fsdp losses part from the plain ones by {rel}")


def phase_bench(tmp: str) -> None:
    """``bench.main(["--quick"])`` in this process (the JSON line it prints
    is passed on): the headline and its eleven rows finite and > 0, the
    MMD kernel launched 12 times (by mmd_eval, the only row that runs it),
    the headline's FlopCounterMode count beside 3x the closed-form forward."""
    result = bench.main(["--quick"])
    launches = kernel_launches()
    rows = result["rows"]
    values = {"headline": result["value"], **{
        name: row["steps_per_sec"] if "steps_per_sec" in row else row["seconds"]
        for name, row in rows.items()}}
    bad = {k: v for k, v in values.items()
           if not (isinstance(v, (int, float)) and math.isfinite(v) and v > 0)}
    fwd = planenet_flops(PATH["dim"], PATH["layers"], PATH["batch"], PATH["samples"])
    emit("bench", measurements=values, launches=launches, peak=result["peak"],
         mfu=result["mfu"], gflops_per_step=result["gflops_per_step"],
         forward_gflop_closed_form=fwd / 1e9,
         step_over_forward=result["gflops_per_step"] * 1e9 / fwd,
         picard_sweeps=rows["ddim_50_picard"]["sweeps"])
    if len(values) != BENCH_MEASUREMENTS or bad:
        raise AssertionError(f"bench: {len(values)} measurements, not finite or > 0: {bad}")
    if launches["gaussian_kernel_sum"] != BENCH_MMD_LAUNCHES:
        raise AssertionError(f"bench: mmd_eval launched gaussian_kernel_sum "
                             f"{launches['gaussian_kernel_sum']} times")


def tree_hash(path: str) -> str:
    """sha256 over the relative paths and bytes of every file under ``path``."""
    h = hashlib.sha256()
    for root, dirs, files in os.walk(path):
        dirs.sort()
        for name in sorted(files):
            full = os.path.join(root, name)
            h.update(os.path.relpath(full, path).encode())
            with open(full, "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def phase_sweep(tmp: str) -> None:
    """``sweep.main``: the lock driver (``--param so3``) over a two-point lr
    grid, one subprocess a point on the card, into a temporary ``--out``;
    both runs exit 0, ``summary.json`` ranks both by their mean loss, and
    the committed ``sweeps/`` is untouched.  The runs' launches happen in
    their own processes."""
    before = tree_hash("sweeps")
    out = os.path.join(tmp, "sweep")
    t0 = time.perf_counter()
    summary = sweep.main(["lock", "--grid", json.dumps(SWEEP["grid"]), "--steps",
                          str(SWEEP["steps"]), "--out", out, "--", "--param", "so3",
                          "--print-every", str(SWEEP["print_every"])])
    seconds = time.perf_counter() - t0
    with open(os.path.join(out, "summary.json")) as f:
        on_disk = json.load(f)
    ranked = on_disk["ranked"]
    emit("sweep", seconds=seconds, ranked=[{k: r[k] for k in ("tag", "returncode", "value",
                                                              "rank")} for r in ranked])
    values = [r["value"] for r in ranked]
    if (on_disk != summary or len(ranked) != 2 or any(r["returncode"] for r in ranked)
            or not all(v is not None and math.isfinite(v) for v in values)
            or values != sorted(values) or [r["rank"] for r in ranked] != [1, 2]):
        raise AssertionError(f"sweep: summary {on_disk}")
    if tree_hash("sweeps") != before:
        raise AssertionError("sweep: the committed sweeps/ changed")


def phase_probe(tmp: str) -> None:
    """``probe_protein`` at the headline width on a checkpoint written here
    (one replayed K = 8 call of the production flags through
    ``protein.main``): the checkpoint's step restored, all 20 MSEs finite,
    the zero predictor's shift MSE (a mean of squared unit normals) within
    0.7-1.3."""
    ckpt = os.path.join(tmp, "probe_ckpt")
    n = PROBE["train_steps"]
    run_captured(protein.main, PROTEIN_ARGV + PRODUCTION + ["--steps", str(n), "--print-every", str(n),
                                                            "--ckpt", ckpt])
    t0 = time.perf_counter()
    table, out = run_captured(probe_protein.main, [
        "--ckpt", ckpt, "--frame-pool", "--cross-depth", str(PROTEIN["cross_depth"]),
        "--rel-frame", "--equiv-head"])
    emit("probe", seconds=time.perf_counter() - t0, timesteps=list(probe_protein.TIMESTEPS),
         rot_model=table[:, 0].tolist(), rot_zero=table[:, 1].tolist(),
         shift_model=table[:, 2].tolist(), shift_zero=table[:, 3].tolist())
    if f"ckpt step: {n}" not in out or table.shape != (5, 4) or not np.isfinite(table).all():
        raise AssertionError(f"probe: step line missing or MSEs not finite: {table}")
    if not ((table[:, 3] > 0.7) & (table[:, 3] < 1.3)).all():
        raise AssertionError(f"probe: zero-predictor shift MSEs {table[:, 3]}")


# the paths, in the order they run: (name, run(tmp), the kernels it must
# launch); each runs in a temporary directory of its own, its launches
# counted from 0
PATHS = [
    ("aircraft", phase_path, ("igso3_logpdf_score",)),
    ("bingham", phase_bingham_path, ("igso3_logpdf_score", "gaussian_kernel_sum")),
    ("aircraft_train", phase_aircraft_train, ("igso3_logpdf_score", "adam_update")),
    ("bingham_train", phase_bingham_train, ("gaussian_kernel_sum", "adam_update")),
    ("protein", phase_protein_path, ("igso3_logpdf_score",)),
    ("protein_train", phase_protein_train, ("adam_update",)),
    ("euler_aircraft", phase_euler_aircraft, ("adam_update",)),
    ("euler_protein", phase_euler_protein, ("adam_update",)),
    ("so3_toy", phase_so3_toy, ("adam_update",)),
    ("lock", phase_lock, ("adam_update",)),
    ("jigsaw", phase_jigsaw, ("adam_update",)),
    ("diagnostics", phase_diagnostics, ("igso3_logpdf_score",)),
    ("moe_aircraft", phase_moe_aircraft, ("adam_update",)),
    ("dsv2_aircraft", phase_dsv2_aircraft, ("adam_update", "moe_rows", "mla_attention")),
    ("kimi_aircraft", phase_kimi_aircraft, ("adam_update", "moe_rows", "mla_attention")),
    ("dp_world1", phase_dp_world1, ("adam_update",)),
    ("bench", phase_bench, ("adam_update", "gaussian_kernel_sum")),
    ("sweep", phase_sweep, ()),
    ("probe", phase_probe, ("adam_update",)),
]


def timed(name: str, fn):
    t0 = time.perf_counter()
    out = fn()
    emit("phase_seconds", name=name, seconds=time.perf_counter() - t0)
    return out


def main() -> None:
    smi = timed("device", phase_device)
    sass = sass_counts(timed("build", phase_build))
    measured = timed("kernels", phase_kernels)
    failed = {name: rec for name, rec in measured.items() if not rec["pass"]}
    if failed:
        raise AssertionError(f"kernels outside their gates against the plain versions: {failed}")
    by_path = {}
    for name, run, must in PATHS:
        obs.reset()
        with tempfile.TemporaryDirectory() as tmp:
            timed(name, lambda: run(tmp))
        by_path[name] = kernel_launches()
        missing = [k for k in must if by_path[name][k] == 0]
        if missing:
            raise AssertionError(f"the {name} path launched no {missing}: {by_path[name]}")
    kernels = [{"name": name, "route": "cuda", "source": f"diffusion_extensions_tpu_torch/csrc/{name}.cu",
                "replaces": spec["replaces"], "launches": sum(p[name] for p in by_path.values()),
                "launches_by_path": {p: n[name] for p, n in by_path.items()}, **measured[name],
                spec["sass"]: sass[name]} for name, spec in KERNELS.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
