#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from the sources in this checkout (one
nvcc per source, all started together; prints what ptxas says of each and,
where cuobjdump is there, the SASS instruction counts), holds each against
its plain PyTorch version on the card (Adam's update at the leaf sets of the
benchmark's two configurations, timed beside the plain version and, with
float32 moments, ``torch.optim.Adam(fused=True)``; the experts layer's six
row-pass kernels at the dsv2lite-aircraft-train cell's shapes, forward and
backward, at ~10,330 held rows and at all T k rows, timed beside their
bytes bound and the plain versions), then drives seventeen
paths at full size, each with the kernels' launch counts set to 0 just
before it and read just after:

* the aircraft sampling path (PlaneNet dim 512 / 4 heads / 4 layers, random
  weights from a seed, batch 32 x 256 points, ProjectedSO3Diffusion with
  T = 1000): a 250-step ancestral chain (T = 250; the 1000-step chain runs
  under the training phase's --test), the 50-step Heun
  probability-flow sampler (whose score runs the IGSO(3) kernel) and
  IsotropicGaussianSO3.log_prob on 50,000 rotations;
* the Bingham evaluation path, ``experiments/bingham.py --test --sampler-ab``
  on the "lcr" preset: RotPredict d_model 65 (seeded init), SO3Diffusion
  T = 1000, 20,000 chains per sampler row, and MMD against 20,000 target
  rotations, whose three 20k x 20k sums run the MMD kernel;
* aircraft training, ``experiments/aircraft.py`` at the same full width:
  10 warm-up + 50 timed steps in fp32, with ``--bf16``, with ``--opt-impl
  fused``, with ``--steps-per-call 8`` (one CUDA graph replayed a step) and
  with ``--bf16 --steps-per-call 8``; 100 steps whose loss must
  fall, a ``--resume`` of 20 more; 2N steps against N + save + restore + N
  and against the same steps replayed from a CUDA graph, to the bit, ``--test`` on the written checkpoint (one chain per
  shape) and 32 Heun-50 chains on the trained weights (100 launches of the
  IGSO(3) kernel);
* Bingham training, ``experiments/bingham.py lcr --steps 2000 --mmd-every
  1000``: two online MMD evaluations (6 launches of the MMD kernel), the
  curve file, then ``--test`` on the written checkpoint;
* the protein docking path at the headline width (ProtNet dim 1024 / 8 heads
  / t_depth 12 / c_depth 8 with frame_pool, cross_depth 2, rel_frame and
  equiv_head: 163,077,652 parameters, seeded init, its output layer scaled
  by 1e-2 for sampling; batch 16 over the 16 synthetic pairs;
  ProjectedSE3Diffusion T = 1000, clip_shift 75): the
  forward in float32 and bf16, then ``experiments/protein.py --test --bf16``
  with DDIM-50 (64 poses), probability-flow 50, Heun-25 (200 launches of the
  IGSO(3) kernel), Picard-10 and the 1000-step ancestral chain (16 poses);
* protein training at the same width: 10 + 96 steps with ``--bf16`` and
  16 + 96 with ``--bf16 --opt-impl fused --opt-state-dtype bf16
  --steps-per-call 8``, 200 steps of the latter whose loss must fall,
  ``--test`` on that checkpoint, 2N replayed steps against N + save +
  restore + N, and two epochs of ``--epoch-accum``;
* the aircraft Euler arm (``--so3`` off: ProjectedGaussianDiffusion, l1) at
  the aircraft width: 10 + 50 ``--bf16 --steps-per-call 8`` steps, 100 fp32
  steps whose loss must fall, ``--test --euler-init haar`` on that checkpoint
  (a 1000-step chain a shape over 32 shapes, gated finite and on SO(3));
* the protein Euler arm (``--se3`` off: ProtNet(se3=False), the same
  163,077,652 weights, ProjectedEulerDiffusion): the forward in float32 and
  bf16, 16 + 96 steps with the production flags, ``--test`` with the
  1000-step ancestral chain, one sample a pose over 16 poses (the seeded
  init, head scaled by PROTEIN_HEAD_SCALE), rotations gated on SO(3) and
  shifts on finiteness;
* ``experiments/so3_toy.py``: 2000 steps at K = 16, then ``--test`` with the
  ancestral, DDIM-50 and probability-flow-50 samplers over 512 chains;
* ``experiments/lock.py``, both ``--param`` arms: 2000 eager steps each,
  then ``--test`` over 512 chains (|axis . y|, the in-range fraction);
* ``experiments/jigsaw.py`` at the JAX driver's width (CoordConv size 128,
  145,378 parameters, seeded init, batch 256, ProjectedGaussianDiffusion
  T = 1000, a fresh puzzle a step rendered on the card): 10 + 50 timed eager
  steps (ms, TFLOP/s against the convolutions' FLOPs, peak memory), 200
  steps whose loss must fall, 2N steps against N + save + restore + N to
  the bit, 20 steps twice with cuDNN's deterministic algorithms off and on
  (same bits? ms a step), then ``--test``: the 1000-step chain over 64
  samples and the placement error in pixels;
* the diagnostics: ``diagnostics se3-path`` at its defaults (14 poses x
  1000 forward steps, each an IGSO3xR3 draw, gated on SO(3) and finite
  shifts), ``grad_check`` at its defaults (2000 Adam steps, the loss must
  halve), and ``IGSO3xR3.log_prob`` over 50,000 poses (kernel 1) against
  the CPU's; no figure (the card's machine has no matplotlib);
* the Switch-MoE aircraft arm (bench.py's moe_train_e4: the aircraft width
  with 4 experts, scatter dispatch, T = 8,192 tokens a layer, C = 2,560)
  through ``aircraft.main``: 208 replayed ``--bf16 --steps-per-call 8``
  steps (ms, steps/s, peak memory, falling loss, expert fractions, the aux
  on the trained weights), the one-hot dispatch timed beside the scatter
  one in turns, replayed and resumed steps against eager ones to the bit,
  then ``--test`` over 32 shapes (1000-step chains, gated on SO(3));
* the DeepSeek-V2 trunk (``--trunk dsv2lite-ep8``: 1 dense + 4 MoE layers
  at DeepSeek-V2-Lite's widths, 8 of 64 experts held, 487,890,436
  parameters) at the dsv2lite-aircraft-train cell's size through
  ``aircraft.main``: 32 replayed bf16 K = 8 steps, then one profiled call
  of a fresh step (Adam's kernel once a step, the six row-pass kernels a
  MoE layer a step, the held experts' rows);
* the multi-process code at world size 1 over NCCL (a group made in this
  process; the card's machine has one GPU): 16 replayed K = 8 steps through
  the data-parallel all-reduce against the same steps without a group, to
  the bit, the all-reduce issued inside the capture; then ``--fsdp``
  (FSDP2) for 20 eager steps against the plain eager steps.
* the system's last entry points: ``bench.main(["--quick"])`` (bench_torch:
  the aircraft headline and bench.py's eleven rows at its configurations,
  12 launches of the MMD kernel by mmd_eval, every measurement finite and
  > 0); ``sweep.main`` over a two-point lr grid of the lock driver, one
  subprocess a point, ranked in a temporary directory with the committed
  ``sweeps/`` untouched; ``probe_protein`` at the headline width on a
  checkpoint written here (the 20 block MSEs finite).

Small runs hold the card against the CPU: sampling (aircraft Heun, Bingham
DDIM), training, the protein slice, and the Euler arms (an aircraft Euler
chain, protein Euler steps, five lock-arm losses per arm), and the jigsaw
slice (images, forward, loss, a 20-step chain), and the MoE PlaneNet
(forward, loss with the aux, routing; both dispatches).
Every phase prints JSON lines, and the seconds each phase took; any failure
raises and exits non-zero.  The last lines are the kernels' summary, the
card's name and power limit as nvidia-smi reports them, and
{"ok": true, "device": {...}}.  The kernels' summary has each kernel's
launches on each path (``launches_by_path``).

Imports torch, numpy and the port only.  There is no CPU path: without a
CUDA device the script exits non-zero before printing any result.
"""
from __future__ import annotations

import contextlib
import hashlib
import io
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
from diffusion_extensions_tpu_torch.data.jigsaw import JigsawPuzzle, puzzle_rows
from diffusion_extensions_tpu_torch.data.pdb import (
    pad_prot_batch,
    synthetic_prot_pair,
    to_device,
)
from diffusion_extensions_tpu_torch.data.shapenet import BatchLoader, synthetic_planes
from diffusion_extensions_tpu_torch.data.synthetic import bingham_dist
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
from diffusion_extensions_tpu_torch.models.coordconv import STAGES, WIDTH, CoordConv
from diffusion_extensions_tpu_torch.models.planenet import PlaneNet
from diffusion_extensions_tpu_torch.models.projections import PointCloudProj, ProtProjection
from diffusion_extensions_tpu_torch.models.protnet import ProtNet
from diffusion_extensions_tpu_torch.models.rot_predict import RotPredict
from diffusion_extensions_tpu_torch.ops import _build, adam_cuda, igso3_cuda, mmd_cuda, moe_rows_cuda
from diffusion_extensions_tpu_torch.ops.igso3 import (
    IGSO3xR3,
    IsotropicGaussianSO3,
    igso3_log_density,
)
from diffusion_extensions_tpu_torch.ops.metrics import mmd
from diffusion_extensions_tpu_torch.ops.se3 import AffineT
from diffusion_extensions_tpu_torch.ops.so3 import (
    exp_skewvec,
    haar_rotations,
    quat_to_rmat,
    rmat_to_euler,
    rotation_angle,
)
from diffusion_extensions_tpu_torch.parallel.dp import make_dp_train_step
from diffusion_extensions_tpu_torch.processes.euler import ProjectedEulerDiffusion
from diffusion_extensions_tpu_torch.processes.r3 import ProjectedGaussianDiffusion
from diffusion_extensions_tpu_torch.processes.se3 import ProjectedSE3Diffusion
from diffusion_extensions_tpu_torch.processes.so3 import ProjectedSO3Diffusion, SO3Diffusion
from diffusion_extensions_tpu_torch.train import optim
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
# gates of tests/test_pallas.py
LOGF_TOL = (1e-5, 1e-5)  # rtol, atol
SCORE_TOL = (1e-4, 5e-4)
MMD_SUM_RTOL = 1e-4
MMD_SWEEP_RTOL = 1e-5  # one X against rotations at theta dense on [0, pi]
MMD_TOL = (1e-3, 1e-5)
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
ADAM_CHECK_STEPS = 3
# the experts layer's row passes at the dsv2lite-aircraft-train cell's shapes:
# T tokens, top k of e experts, `held` of them held, widths d and f.
# held_bias lowers the held experts' scores so that about 10,330 of the
# T k rows are held, as the cell's untrained router holds them ("cell");
# "all" holds every expert (n = T k)
MOE_ROWS = dict(t=16_384, k=6, e=64, held=8, d=2048, f=1408, held_bias=-0.105)
MOE_ROWS_KERNELS = ("moe_gather_rows", "moe_gather_rows_backward", "moe_swiglu_rows",
                    "moe_swiglu_rows_backward", "moe_combine_rows", "moe_combine_rows_backward")
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
# (cut from 40,000), N of N + save + restore + N, steps timed with and
# without cuDNN's deterministic algorithms, --test over 64 chains
JIGSAW = dict(size=128, batch=256, timesteps=1000, warmup=10, timed=50, fall_steps=200,
              exact_n=10, det_steps=20, eval_batch=64)
# the diagnostics: se3-path and grad_check at their defaults, IGSO3xR3.log_prob
# over 50,000 poses on the card against the CPU
DIAG = dict(se3_samples=14, se3_steps=1000, grad_iters=2000, log_prob_n=50_000)
# the Switch-MoE aircraft arm (bench.py's moe_train_e4): replayed --bf16 K = 8
# steps, the logging interval (each row runs the probe and reads the expert
# fractions)
MOE = dict(experts=4, steps=208, print_every=8)
# world size 1 over NCCL: replayed K = 8 steps through the all-reduce, eager
# --fsdp steps
DP_WORLD1 = dict(steps=16, fsdp_steps=20)
# the DeepSeek-V2 trunk (--trunk dsv2lite-ep8) at the dsv2lite-aircraft-train
# cell's size: replayed bf16 K = 8 steps through aircraft.main, then one
# profiled call of a fresh step
DSV2 = dict(trunk="dsv2lite-ep8", batch=64, samples=256, params=487_890_436, steps=32, print_every=8)
# bench_torch --quick: the headline and its eleven rows, the kernel-2
# launches of mmd_eval (one warm-up call and three timed, three sums each)
BENCH_MEASUREMENTS, BENCH_MMD_LAUNCHES = 12, 12
# the sweep: two lock runs (--param so3) over this grid, each this many steps
SWEEP = dict(grid={"lr": [1e-4, 3e-4]}, steps=50, print_every=10)
# the probe: the headline flags' checkpoint after one replayed K = 8 call
PROBE = dict(train_steps=8)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def kernel_launches() -> dict:
    """Each kernel's launches since the last ``obs.reset()``."""
    return {"igso3_logpdf_score": obs.counter("ops.igso3.launches"),
            "gaussian_kernel_sum": obs.counter("ops.mmd.launches"),
            "adam_update": obs.counter("ops.adam.launches"),
            "moe_rows": obs.counter("ops.moe_rows.launches")}


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


def score_atol_across_libraries(t: torch.Tensor) -> torch.Tensor:
    """The score's atol against a plain version run by another math library
    (the CPU's).  For t >= 1e-4 the score is a difference of two terms of
    size 1/t, each rounded on its own, so two correct evaluations may differ
    by an ulp of 1/t in each: max(5e-4, 2 ulp(1/t)), which is 5e-4 from
    t = 4.9e-4 up and at most 1.95e-3 (at t = 1e-4).  Below 1e-4 the score
    takes its small-t limit and keeps 5e-4."""
    inv = 1.0 / t.clamp(min=1e-4)
    ulp = torch.nextafter(inv, torch.full_like(inv, float("inf"))) - inv
    return torch.where(t >= 1e-4, (2.0 * ulp).clamp(min=SCORE_TOL[1]),
                       torch.full_like(inv, SCORE_TOL[1]))


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
    kernels = {"igso3_logpdf_score": igso3_cuda, "gaussian_kernel_sum": mmd_cuda,
               "adam_update": adam_cuda, "moe_rows": moe_rows_cuda}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:
        futures = {name: pool.submit(mod.build) for name, mod in kernels.items()}
        for fut in futures.values():
            fut.result()
    sass = {}
    for name, mod in kernels.items():
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
           "moe_rows": sass_instructions(sass["moe_rows"])}
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


def allocations() -> int:
    return torch.cuda.memory_stats()["allocation.all.allocated"]


def phase_kernel_check() -> dict:
    """The kernel against its plain version on the card, then timings."""
    cases = {}
    for n in (PROTEIN["batch"], PATH["batch"], BINGHAM_N, 1000, 2**20 + 37):
        cases[str(n)] = kernel_inputs(n, seed=n)
    t7 = torch.linspace(0.1, 3.0, 7, device="cuda").reshape(7, 1)
    cases["(7,1)x(1,)"] = (t7, torch.tensor([0.5], device="cuda"))
    # the log_prob shape: many angles, one sigma
    t50k = kernel_inputs(PATH["log_prob_n"], seed=50)[0]
    cases["50000 x one sigma"] = (t50k, torch.tensor(0.5, device="cuda"))
    # the cancellation band and the switch between the kernel's two paths
    band = torch.from_numpy(np.geomspace(1e-4, 5e-2, 4096).astype(np.float32)).cuda()
    for sigma in (0.05, 0.4, 1.0, 1.5):
        cases[f"band sigma {sigma}"] = (band, torch.tensor(sigma, device="cuda"))
    # a t that starts off a 16-byte boundary, and one t against many sigma
    t1k, s1k = cases["1000"]
    cases["unaligned"] = (t1k[1:], s1k[1:])
    cases["one t"] = (torch.tensor(0.7, device="cuda"), s1k)
    worst = {"logf_abs": 0.0, "logf_gate": 0.0, "score_abs": 0.0, "score_gate": 0.0}
    for name, (t, s) in cases.items():
        logf, score = igso3_cuda.igso3_logpdf_score(t, s)
        sync()
        assert torch.isfinite(logf).all() and torch.isfinite(score).all(), name
        # against the plain version on the card (which rounds as the kernel's
        # exact path does: atol 5e-4 everywhere), and on the CPU
        for dev in ("cuda", "cpu"):
            ref_logf, ref_score = igso3_cuda.igso3_logpdf_score_ref(t.to(dev), s.to(dev))
            assert logf.shape == ref_logf.shape and score.shape == ref_score.shape, name
            la, lg = gate(logf.to(dev), ref_logf, *LOGF_TOL)
            score_atol = SCORE_TOL[1] if dev == "cuda" else score_atol_across_libraries(t.cpu())
            sa, sg = gate(score.to(dev), ref_score, SCORE_TOL[0], score_atol)
            emit("kernel_check", kernel="igso3_logpdf_score", case=name, plain_on=dev,
                 logf_max_abs_err=la, logf_gate_ratio=lg, score_max_abs_err=sa,
                 score_gate_ratio=sg)
            if dev == "cuda":
                for k, v in (("logf_abs", la), ("score_abs", sa)):
                    worst[k] = max(worst[k], v)
            for k, v in (("logf_gate", lg), ("score_gate", sg)):
                worst[k] = max(worst[k], v)
    ok = worst["logf_gate"] <= 1.0 and worst["score_gate"] <= 1.0
    if not ok:
        raise AssertionError(f"igso3_logpdf_score disagrees with its plain version: {worst}")

    # on its exact path (t < EXACT_BELOW) the kernel is the plain version to the
    # bit; below t = 1e-4 the score's limit may differ by an ulp (of ~1e-5),
    # because on the card PyTorch divides t by 12 as a product with 1/12
    t, s = kernel_inputs(BINGHAM_N, seed=2)
    below = float(np.nextafter(np.float32(igso3_cuda.EXACT_BELOW), np.float32(0)))
    t = (t * (below / np.pi)).clamp(max=below)
    logf, score = igso3_cuda.igso3_logpdf_score(t, s)
    ref_logf, ref_score = igso3_cuda.igso3_logpdf_score_ref(t, s)
    direct = t >= 1e-4
    exact = bool(torch.equal(logf, ref_logf) and torch.equal(score[direct], ref_score[direct]))
    _, limit_gate = gate(score[~direct], ref_score[~direct], *SCORE_TOL)
    emit("kernel_check", kernel="igso3_logpdf_score", case="exact path", bit_identical=exact,
         cheap_elements=int(igso3_cuda.cheap_domain(t, s).sum()),
         elements_below_1e_4=int((~direct).sum()), limit_gate_ratio=limit_gate)
    if not (exact and limit_gate <= 1.0):
        raise AssertionError("igso3_logpdf_score: the exact path differs from the plain version")

    # one sigma is read in place: the call allocates its outputs and nothing else
    t, s = cases["50000 x one sigma"]
    sigma_arg = igso3_cuda.plan_operands(t, s)[3]
    before = allocations()
    igso3_cuda.igso3_logpdf_score(t, s)
    made = allocations() - before
    emit("kernel_check", kernel="igso3_logpdf_score", case="one sigma in place",
         allocations=made, passed_as_it_is=sigma_arg is s)
    if made != 1 or sigma_arg is not s:
        raise AssertionError(f"one sigma: {made} allocations in the call (expected 1)")

    # ms / plain_ms: device time per call (CUDA graph replay);
    # call_ms / plain_call_ms: per eager call from Python, what a chain pays
    timing = {}
    shapes = [(n, False) for n in (PROTEIN["batch"], PATH["batch"], BINGHAM_N, 2**20)]
    shapes += [(PATH["log_prob_n"], True), (2**20, True)]
    for n, one_sigma in shapes:
        t, s = kernel_inputs(n, seed=1)
        if one_sigma:
            s = torch.tensor(0.5, device="cuda")
        kernel = lambda: igso3_cuda.igso3_logpdf_score(t, s)  # noqa: E731
        plain = lambda: igso3_cuda.igso3_logpdf_score_ref(t, s)  # noqa: E731
        bound_ms, bound_by = igso3_bound_ms(n, one_sigma)
        key = f"{n} one sigma" if one_sigma else n
        timing[key] = dict(
            ms=time_graph(kernel), plain_ms=time_graph(plain, reps=20),
            call_ms=time_cuda(kernel, 1000), plain_call_ms=time_cuda(plain, 100),
            bound_ms=bound_ms, bound_by=bound_by,
        )
        emit("kernel_time", kernel="igso3_logpdf_score", n=n, one_sigma=one_sigma,
             **timing[key])
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


def theta_sweep(m: int = 4096):
    """One X against m rotations X exp(theta axis), theta dense on [0, pi]
    with both ends (float64, then cast); also sum exp(-sqrt(2) theta)."""
    theta = np.linspace(0.0, np.pi, m)
    axis = np.array([0.3, -0.5, 0.81])
    axis /= np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    rel = (np.eye(3) + np.sin(theta)[:, None, None] * k
           + (1 - np.cos(theta))[:, None, None] * (k @ k))
    x = rotations(1, 21).double()
    y = (x @ torch.from_numpy(rel).cuda()).float()
    return x.float(), y, float(np.exp(-np.sqrt(2.0) * theta).sum())


def plain_mmd(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    def s(a, b):
        return mmd_cuda.gaussian_kernel_sum_ref(a, b, chunksize=4000)

    n, m = x.shape[0], y.shape[0]
    return s(x, x) / n**2 + s(y, y) / m**2 - 2.0 * s(x, y) / (n * m)


def phase_mmd_check() -> dict:
    """The MMD kernel against its plain version on the card (rtol 1e-4 on
    each sum, 1e-5 on the theta sweep), mmd_cuda against the plain MMD
    (rtol 1e-3, atol 1e-5), two calls at 20k x 20k bit-identical, then
    timings at the path's 20k x 20k."""
    n = BINGHAM_N
    tile_n, tile_m = mmd_cuda.tile_shape()
    emit("kernel_check", kernel="gaussian_kernel_sum", case="tile", x_rows=tile_n, y_rows=tile_m)
    sweep_x, sweep_y, sweep_sum = theta_sweep()
    cases = {
        "theta sweep 1x4096": (sweep_x, sweep_y),
        # a ragged tile in each direction of the built tile shape
        "under one tile": (rotations(tile_n - 3, 13), rotations(tile_m - 1, 14)),
        "one column": (rotations(tile_n + 5, 15), rotations(1, 16)),
        "tile plus one": (rotations(tile_n + 1, 17), rotations(tile_m + 1, 18, 0.3)),
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
        rtol = MMD_SWEEP_RTOL if name.startswith("theta sweep") else MMD_SUM_RTOL
        emit("kernel_check", kernel="gaussian_kernel_sum", case=name, sum=float(got),
             plain_sum=float(want), abs_err=abs_err, rel_err=rel_err, rtol=rtol)
        if not (torch.isfinite(got) and rel_err <= rtol):
            raise AssertionError(f"gaussian_kernel_sum {name}: {float(got)} vs plain "
                                 f"{float(want)} (rel err {rel_err})")
        worst_abs, worst_rel = max(worst_abs, abs_err), max(worst_rel, rel_err)
    sweep_rel = abs(float(mmd_cuda.gaussian_kernel_sum(sweep_x, sweep_y)) - sweep_sum) / sweep_sum
    emit("kernel_check", kernel="gaussian_kernel_sum", case="theta sweep vs float64",
         rel_err=sweep_rel, rtol=MMD_SWEEP_RTOL)
    if not sweep_rel <= MMD_SWEEP_RTOL:
        raise AssertionError(f"gaussian_kernel_sum theta sweep: rel err {sweep_rel}")
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


def phase_adam_check() -> dict:
    """Adam's update kernel at the leaf sets of the benchmark's two
    configurations (``ADAM_SETS``): ``ADAM_CHECK_STEPS`` steps of
    ``Adam.step()`` against the same steps through the plain version, to
    the bit, one launch a step; then device ms a call (a CUDA graph
    replayed) of the kernel, of the plain version and, with float32
    moments, of ``torch.optim.Adam(fused=True)`` as a yardstick the port
    never calls, and the eager call's ms (host and device)."""
    out = {}
    for name, (kind, impl, dtype) in ADAM_SETS.items():
        shapes = adam_leaf_shapes(kind)
        gen = torch.Generator(device="cuda").manual_seed(0)
        init = [torch.randn(s, device="cuda", generator=gen) * 0.02 for s in shapes]
        grads = [torch.randn(s, device="cuda", generator=gen) * 1e-3 for s in shapes]
        mine = [(f"w{i}", torch.nn.Parameter(w.clone())) for i, w in enumerate(init)]
        ref = [(f"w{i}", torch.nn.Parameter(w)) for i, w in enumerate(init)]
        kernel = make_optimizer(mine, 1e-4, impl=impl, state_dtype=dtype)
        plain = make_optimizer(ref, 1e-4, impl=impl, state_dtype=dtype)
        for (_, p), (_, q), g in zip(mine, ref, grads):
            p.grad, q.grad = g, g
        obs.reset()
        for _ in range(ADAM_CHECK_STEPS):
            kernel.step()
            with mock.patch.object(optim, "adam_update", adam_cuda.adam_update_ref):
                plain.step()
        sync()
        launches = obs.counter("ops.adam.launches")
        same = all(torch.equal(p, q) for (_, p), (_, q) in zip(mine, ref)) and all(
            torch.equal(a, b) for a, b in zip(kernel.mu + kernel.nu, plain.mu + plain.nu))
        emit("kernel_check", kernel="adam_update", case=name, impl=impl, state_dtype=dtype,
             steps=ADAM_CHECK_STEPS, launches=launches, bit_identical=same)
        if launches != ADAM_CHECK_STEPS or not same:
            raise AssertionError(f"adam_update {name}: {launches} launches in "
                                 f"{ADAM_CHECK_STEPS} steps, bit-identical {same}")

        ps, qs = [p.detach() for _, p in mine], [q.detach() for _, q in ref]
        scalars = [torch.tensor(v, device="cuda") for v in (1e-4, 0.1, 1e-3)]
        kw = dict(impl=impl, b1=0.9, b2=0.999, eps=1e-8, clip=0.0)
        def run():
            adam_cuda.adam_update(ps, grads, kernel.mu, kernel.nu, *scalars, None, **kw)

        def run_plain():
            adam_cuda.adam_update_ref(qs, grads, plain.mu, plain.nu, *scalars, None, **kw)

        n = sum(p.numel() for p in ps)
        bound_ms = ADAM_BYTES[dtype] * n / HBM_BYTES_PER_S * 1e3
        timing = dict(leaves=len(shapes), n=n, impl=impl, state_dtype=dtype,
                      ms=time_graph(run), plain_ms=time_graph(run_plain, reps=10),
                      call_ms=time_cuda(run, 50), plain_call_ms=time_cuda(run_plain, 10, warmup=2),
                      bound_ms=bound_ms, bound_by="bytes", library_ms=None)
        if dtype == "f32":
            lib = torch.optim.Adam([q for _, q in ref], lr=1e-4, fused=True, capturable=True)
            timing["library_ms"] = time_graph(lib.step)
        timing["roofline_pct"] = 100.0 * bound_ms / timing["ms"]
        emit("kernel_time", kernel="adam_update", set=name, **timing)
        out[name] = timing
        del kernel, plain, mine, ref, init, grads, ps, qs
        torch.cuda.empty_cache()
    return out


def moe_rows_operands(case: str, seed: int = 0) -> dict:
    """A routing drawn on the card at MOE_ROWS's shapes (``"cell"`` or
    ``"all"``), its plan, and each pass's inputs and incoming gradients,
    rows past n filled with NaN (the kernels never read them)."""
    c = MOE_ROWS
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


def phase_moe_rows_check() -> dict:
    """The experts layer's six row-pass kernels (``ops/moe_rows_cuda.py``)
    at MOE_ROWS's shapes, at ~10,330 held rows and at all T k: each pass
    forward and backward through the wrapper against its plain version
    (autograd), the rows under n and the per-token results to the bit, the
    combine's weight gradient within 2 d 2^-24 sum |g y| (a float32 dot
    product summed in another order), six launches; then each kernel's
    device ms (a CUDA graph replayed, outputs allocated once) beside its
    bytes bound, and the plain version's ms (its forward, or its backward
    alone through ``torch.autograd.grad``)."""
    mr = moe_rows_cuda
    out = {}
    for case in ("cell", "all"):
        o = moe_rows_operands(case)
        n, order, inv, offs, mine = o["n"], o["order"], o["inv"], o["offs"], o["mine"]
        obs.reset()
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
            res[kernel] = [xs[:n], dtok, h[:n], dh1[:n], y, dys[:n], dw]
        sync()
        launches = obs.counter("ops.moe_rows.launches")
        same = all(torch.equal(a, b) for a, b in zip(res[True][:6], res[False][:6]))
        finite = all(bool(torch.isfinite(a).all()) for a in res[True])
        rows = o["ys"].float().index_select(0, inv).view(o["t"], o["k"], -1)
        scale = torch.where(mine, (o["grad_out"][:, None, :] * rows).abs().sum(-1), 0.0)
        err = (res[True][6] - res[False][6]).abs()
        gate = float((err / (2 * o["d"] * 2.0**-24 * scale).clamp_min(1e-30)).max())
        emit("kernel_check", kernel="moe_rows", case=case, n=n, rows=o["t"] * o["k"], launches=launches,
             bit_identical=same, finite=finite, grad_w_max_abs_err=float(err.max()), grad_w_gate_ratio=gate)
        if launches != 6 or not same or not finite or gate > 1.0:
            raise AssertionError(f"moe_rows {case}: {launches} launches, bit-identical {same}, finite "
                                 f"{finite}, grad_w at {gate} of its gate")
        del res

        def empty(*shape, dt=torch.bfloat16):
            return torch.empty(shape, device="cuda", dtype=dt)

        t, k, d, f = o["t"], o["k"], o["d"], o["f"]
        xs_o, tok_o, h_o, dh1_o = empty(t * k, d), empty(t, d, dt=torch.float32), empty(t * k, f), empty(
            t * k, 2 * f)
        y_o, dys_o, dw_o = empty(t, d, dt=torch.float32), empty(t * k, d), empty(t, k, dt=torch.float32)
        kernels = {
            "moe_gather_rows": lambda: mr.launch_gather(o["tokens"], order, offs, xs_o),
            "moe_gather_rows_backward": lambda: mr.launch_gather_backward(o["grad_xs"], inv, offs, tok_o),
            "moe_swiglu_rows": lambda: mr.launch_swiglu(o["h1"], offs, h_o),
            "moe_swiglu_rows_backward": lambda: mr.launch_swiglu_backward(o["grad_h"], o["h1"], offs, dh1_o),
            "moe_combine_rows": lambda: mr.launch_combine(o["ys"], o["w"], inv, offs, y_o),
            "moe_combine_rows_backward": lambda: mr.launch_combine_backward(
                o["grad_out"], o["ys"], o["w"], inv, offs, dys_o, dw_o),
        }
        tokens = o["tokens"].clone().requires_grad_(True)
        h1 = o["h1"].clone().requires_grad_(True)
        ys, w = o["ys"].clone().requires_grad_(True), o["w"].clone().requires_grad_(True)
        xs_p = mr.gather_ref(tokens, order, inv, offs, torch.bfloat16)
        h_p = mr.swiglu_ref(h1)
        y_p = mr.combine_ref(ys, w, inv, offs)
        plain = {
            "moe_gather_rows": lambda: mr.gather_ref(o["tokens"], order, inv, offs, torch.bfloat16),
            "moe_gather_rows_backward": lambda: torch.autograd.grad(xs_p, [tokens], o["grad_xs"],
                                                                    retain_graph=True),
            "moe_swiglu_rows": lambda: mr.swiglu_ref(o["h1"]),
            "moe_swiglu_rows_backward": lambda: torch.autograd.grad(h_p, [h1], o["grad_h"], retain_graph=True),
            "moe_combine_rows": lambda: mr.combine_ref(o["ys"], o["w"], inv, offs),
            "moe_combine_rows_backward": lambda: torch.autograd.grad(y_p, [ys, w], o["grad_out"],
                                                                     retain_graph=True),
        }
        nbytes = moe_rows_bytes(o)
        out[case] = {"n": n}
        for name in MOE_ROWS_KERNELS:
            bound_ms = nbytes[name] / HBM_BYTES_PER_S * 1e3
            with torch.set_grad_enabled("backward" in name):
                plain_ms = time_cuda(plain[name], 10, warmup=2)
            timing = dict(ms=time_graph(kernels[name], reps=20), plain_ms=plain_ms, bound_ms=bound_ms,
                          bytes=nbytes[name], bound_by="bytes")
            timing["roofline_pct"] = 100.0 * bound_ms / timing["ms"]
            emit("kernel_time", kernel=name, case=case, n=n, **timing)
            out[case][name] = timing
        del o, kernels, plain, xs_p, h_p, y_p
        torch.cuda.empty_cache()
    return out


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
    launches in this run and the forward's ms."""
    device = torch.device("cuda")
    t0 = time.perf_counter()
    torch.manual_seed(0)
    model = PlaneNet(dim=PATH["dim"], heads=PATH["heads"], layers=PATH["layers"]).to(device).eval()
    process = ProjectedSO3Diffusion(PATH["timesteps"], device=device)
    short_process = ProjectedSO3Diffusion(PATH["ancestral_steps"], device=device)
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
    obs.reset()
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
    total = kernel_launches()

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
    return total, fwd_ms


def phase_bingham_path() -> dict:
    """experiments/bingham.py --test --sampler-ab at full size, seeded init,
    records into a temporary directory; returns each kernel's launches."""
    if (bingham.SAMPLES, bingham.NET_SAMPLES) != (BINGHAM_N, BINGHAM_N):
        raise AssertionError(f"bingham.SAMPLES = {bingham.SAMPLES}, expected {BINGHAM_N}")
    obs.reset()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rows = bingham.main([BINGHAM_COV, "--test", "--sampler-ab", "--timesteps", "1000",
                             "--out-dir", tmp, "--ckpt", os.path.join(tmp, "none.pt")])
        seconds = time.perf_counter() - t0
        files = sorted(os.listdir(tmp))
    total = kernel_launches()
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


def small_train_agreement() -> None:
    """Five train steps on the card against the same five on the CPU: PlaneNet
    dim 32 / 2 heads / 1 layer, batch 8 x 16 points, T = 100, the same init,
    clouds, t and noise (drawn once on the CPU), Adam lr 1e-3: each step's
    loss within rtol 1e-4."""
    rng = np.random.default_rng(11)
    clouds = torch.from_numpy(rng.standard_normal((5, 8, 16, 3)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 100, (5, 8)))
    torch.manual_seed(11)
    init = PlaneNet(dim=32, heads=2, layers=1).state_dict()
    proc_cpu = ProjectedSO3Diffusion(100, device="cpu")
    gen = torch.Generator().manual_seed(12)
    noise = torch.stack([proc_cpu.sample_noise(gen, t[i]) for i in range(5)])
    losses = {}
    for dev in ("cpu", "cuda"):
        model = PlaneNet(dim=32, heads=2, layers=1)
        model.load_state_dict(init)
        model = model.to(dev)
        proc = proc_cpu if dev == "cpu" else ProjectedSO3Diffusion(100, device=dev)
        opt = make_optimizer(model.named_parameters(), 1e-3)
        step = make_dp_train_step(aircraft.make_loss_fn(model, proc), model, opt)
        state = TrainState(model, opt, torch.Generator(device=dev))
        losses[dev] = []
        for i in range(5):
            state, m = step(state, (clouds[i].to(dev), t[i].to(dev), noise[i].to(dev)))
            losses[dev].append(float(m["loss"]))
    rel = max(abs(a - b) / abs(a) for a, b in zip(losses["cpu"], losses["cuda"]))
    emit("small_agreement", run="train_5_steps", loss_cpu=losses["cpu"],
         loss_cuda=losses["cuda"], max_rel_err=rel, rtol=1e-4)
    if not rel < 1e-4:
        raise AssertionError(f"train steps: card and CPU losses differ by {rel}")


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
    return {"resume": diff(full, resumed), "captured": diff(full, graphed),
            "captured_then_resume": diff(full, graphed_resumed)}


def phase_aircraft_train(fwd_ms: float) -> dict:
    """Aircraft training at full width through ``aircraft.main``; returns
    each kernel's launches in this phase."""
    obs.reset()
    steps = TRAIN["warmup"] + TRAIN["timed"]
    base = ["--so3", "--dim", str(PATH["dim"]), "--heads", str(PATH["heads"]),
            "--layers", str(PATH["layers"]), "--batch", str(PATH["batch"]),
            "--samples", str(PATH["samples"]), "--timesteps", str(PATH["timesteps"])]
    variants = [("fp32", []), ("bf16", ["--bf16"]), ("fused", ["--opt-impl", "fused"]),
                ("k8", ["--steps-per-call", "8"]),
                ("bf16_k8", ["--bf16", "--steps-per-call", "8"])]
    with tempfile.TemporaryDirectory() as tmp:
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
        ckpt, log = os.path.join(tmp, "fall"), os.path.join(tmp, "fall.jsonl")
        n = TRAIN["fall_steps"]
        common = base + ["--print-every", "1", "--ckpt-every", "100", "--ckpt", ckpt,
                         "--log", log]
        _, out = run_captured(aircraft.main, common + ["--steps", str(n)])
        rows = read_jsonl(log)
        first = float(np.mean([r["loss"] for r in rows[:10]]))
        last = float(np.mean([r["loss"] for r in rows[-10:]]))
        files = sorted(os.listdir(ckpt))
        more = n + TRAIN["resume_more"]
        state, _ = run_captured(aircraft.main, common + ["--steps", str(more), "--resume"])
        resumed = read_jsonl(log)[len(rows):]
        emit("aircraft_train", run="falling_loss_and_resume", steps=n, loss_first_10=first,
             loss_last_10=last, test_loss_first=rows[0]["test_loss"],
             test_loss_last=rows[-1]["test_loss"], checkpoints=files,
             resumed_first_step=resumed[0]["step"], resumed_last_step=state.step)
        if len(rows) != n or not all(np.isfinite(r["loss"]) for r in rows + resumed):
            raise AssertionError("aircraft_train: missing or non-finite loss rows")
        if not last < first:
            raise AssertionError(f"aircraft_train: loss did not fall ({first} -> {last})")
        if files != [f"step_{k:08d}.pt" for k in sorted({*range(100, n + 1, 100), n})[-3:]]:
            raise AssertionError(f"aircraft_train: checkpoints {files}")
        if (resumed[0]["step"], state.step, latest_step(ckpt)) != (n + 1, more, more):
            raise AssertionError(f"aircraft_train: resume ran {resumed[0]['step']}..{state.step}")

        diffs = exact_resume_check(tmp)
        emit("aircraft_train", run="exact_resume", n=TRAIN["exact_n"], max_abs_diff=diffs,
             bit_identical=all(d == 0.0 for d in diffs.values()))
        if any(d != 0.0 for d in diffs.values()):
            raise AssertionError(f"aircraft_train: weights differ from 2N eager steps: {diffs}")

        # --test reads the checkpoint directory (one chain per shape here)
        per_shape = aircraft.SAMPLES_PER_SHAPE
        aircraft.SAMPLES_PER_SHAPE = 1
        try:
            t0 = time.perf_counter()
            res, out = run_captured(aircraft.main, base + ["--test", "--max-shapes",
                                                           str(PATH["batch"]), "--ckpt", ckpt])
            seconds = time.perf_counter() - t0
        finally:
            aircraft.SAMPLES_PER_SHAPE = per_shape
        emit("aircraft_train", run="test_on_checkpoint", seconds=seconds, samples=len(res),
             median_angle=float(np.median(res)))
        if "no checkpoint found" in out or res.shape != (PATH["batch"],) \
                or not np.isfinite(res).all():
            raise AssertionError("aircraft_train: --test did not evaluate the checkpoint")

        # the Heun sampler on the trained weights runs the IGSO(3) kernel
        device = torch.device("cuda")
        model, process = aircraft.build(aircraft.parse_args(base), device)
        if not load_eval_weights(model.eval(), ckpt, device):
            raise AssertionError("aircraft_train: no weights to sample from")
    clouds = subsample_points(synthetic_planes(128, seed=2), PATH["samples"], seed=17)
    proj = PointCloudProj(torch.from_numpy(clouds[: PATH["batch"]]).to(device))
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
    return kernel_launches()


def phase_bingham_train() -> dict:
    """experiments/bingham.py training on the "lcr" preset with the online MMD
    curve, then --test on its checkpoint; returns each kernel's launches."""
    obs.reset()
    steps, every = TRAIN["bingham_steps"], TRAIN["bingham_mmd_every"]
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, log = os.path.join(tmp, "ck"), os.path.join(tmp, "log.jsonl")
        t0 = time.perf_counter()
        curve = bingham.main([BINGHAM_COV, "--steps", str(steps), "--mmd-every", str(every),
                              "--print-every", str(TRAIN["bingham_print_every"]),
                              "--out-dir", tmp, "--ckpt", ckpt,
                              "--log", log])[BINGHAM_COV]
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
        curve_file = os.path.join(tmp, f"torch_bingham_mmd_curve_{BINGHAM_COV}.json")
        with open(curve_file) as f:
            stored = json.load(f)
        if stored != curve or len(curve) != 2 or curve[-1]["step"] != steps:
            raise AssertionError(f"bingham_train: curve {curve}, file {stored}")
        if not all(np.isfinite(c["mmd"]) for c in curve):
            raise AssertionError(f"bingham_train: MMD not finite: {curve}")
        if train_launches != 6:
            raise AssertionError(f"bingham_train: {train_launches} MMD kernel launches, not 6")
        if not all(np.isfinite(r["loss"]) for r in rows) or latest_step(ckpt) != steps:
            raise AssertionError("bingham_train: non-finite loss or no final checkpoint")
        recs, out = run_captured(bingham.main, [BINGHAM_COV, "--test", "--out-dir", tmp,
                                                "--ckpt", ckpt])
        rec = recs[BINGHAM_COV][0]
        emit("bingham_train", run="test_on_checkpoint", mmd=rec["mmd"], passes=rec["passes"],
             accept_threshold=rec["accept_threshold"], seconds=rec["sample_seconds"],
             launches=rec["launches"])
        if "untrained" in out or not np.isfinite(rec["mmd"]):
            raise AssertionError("bingham_train: --test did not evaluate the checkpoint")
    return kernel_launches()


def small_protein_agreement() -> None:
    """The protein slice on the card against the same on the CPU: ProtNet
    dim 64 / 4 heads / t_depth 2 / c_depth 3 with every flag (frame_pool,
    cross_depth 2, rel_frame, equiv_head), float32, one seeded init with its
    output layer scaled by 0.1, 4 synthetic pairs of 40 / 20 residues.  The
    forward: rtol 1e-4 of its largest output; a DDIM-10 chain at T = 50 from
    one x_init: 1e-3 on rotation entries and of 1 + the largest |shift|; 5
    Adam steps (lr 1e-3) on the same batches, t and noise (drawn once on the
    CPU): each loss rtol 1e-4."""
    cfg = dict(dim=64, heads=4, t_depth=2, c_depth=3, frame_pool=True, cross_depth=2,
               rel_frame=True, equiv_head=True)
    torch.manual_seed(13)
    init = ProtNet(**cfg)
    with torch.no_grad():
        init.head_out.weight.mul_(0.1)
        init.head_out.bias.mul_(0.1)
    rng = np.random.default_rng(13)
    batch_np = pad_prot_batch([synthetic_prot_pair(rng, 40 - i, 20 - i) for i in range(4)])
    t_fwd = torch.tensor([0, 10, 30, 49])
    x_init = AffineT(haar_rotations(torch.Generator().manual_seed(14), (4,)),
                     torch.randn(4, 3, generator=torch.Generator().manual_seed(15)))
    proc_cpu = ProjectedSE3Diffusion(50, clip_shift=75.0, device="cpu")
    gen = torch.Generator().manual_seed(16)
    t_train = torch.randint(0, 50, (5, 4), generator=gen)
    noise = [proc_cpu.sample_noise(gen, t_train[i]) for i in range(5)]
    outs = {}
    for dev in ("cpu", "cuda"):
        model = ProtNet(**cfg)
        model.load_state_dict(init.state_dict())
        model = model.to(dev)
        proc = proc_cpu if dev == "cpu" else ProjectedSE3Diffusion(50, clip_shift=75.0,
                                                                   device=dev)
        batch = to_device(batch_np, dev)
        proj = ProtProjection(batch)
        with torch.inference_mode():
            fwd = model.eval()(proj(AffineT.identity((4,), device=dev)), t_fwd.to(dev))
            chain = proc.ddim_sample_loop(model, None, (4,), 10, proj,
                                          x_init=AffineT(x_init.rot.to(dev), x_init.shift.to(dev)))
        opt = make_optimizer(model.train().named_parameters(), 1e-3)
        step = make_dp_train_step(protein.make_loss_fn(model, proc), model, opt)
        state = TrainState(model, opt, torch.Generator(device=dev))
        losses = []
        for i in range(5):
            state, m = step(state, (batch, t_train[i].to(dev),
                                    (noise[i].rot.to(dev), noise[i].shift.to(dev))))
            losses.append(float(m["loss"]))
        outs[dev] = (torch.cat((fwd.rot_g, fwd.shift_g), -1).cpu(), chain.rot.cpu(),
                     chain.shift.cpu(), losses)
    (f_c, r_c, s_c, l_c), (f_g, r_g, s_g, l_g) = outs["cpu"], outs["cuda"]
    fwd_err = float((f_c - f_g).abs().max()) / float(f_c.abs().max())
    rot_err = float((r_c - r_g).abs().max())
    shift_err = float((s_c - s_g).abs().max()) / (1.0 + float(s_c.abs().max()))
    loss_err = max(abs(a - b) / abs(a) for a, b in zip(l_c, l_g))
    emit("small_agreement", run="protein", forward_rel_err=fwd_err, forward_rtol=1e-4,
         ddim_10_rot_err=rot_err, ddim_10_shift_rel_err=shift_err, chain_tol=1e-3,
         loss_cpu=l_c, loss_cuda=l_g, loss_max_rel_err=loss_err, loss_rtol=1e-4)
    if not (fwd_err < 1e-4 and rot_err < 1e-3 and shift_err < 1e-3 and loss_err < 1e-4):
        raise AssertionError(f"protein: card and CPU disagree: forward {fwd_err}, chain "
                             f"{rot_err} / {shift_err}, losses {loss_err}")


def phase_protein_path(tmp: str) -> dict:
    """The protein docking path at the headline width: the forward's time in
    float32 and bf16, then experiments/protein.py --test --bf16 with each
    sampler row (the seeded init, its output layer scaled by
    PROTEIN_HEAD_SCALE, passed as a state dict; records into ``tmp``);
    returns each kernel's launches in this phase."""
    device = torch.device("cuda")
    torch.manual_seed(0)
    with torch.device(device):
        model = ProtNet(dim=PROTEIN["dim"], heads=PROTEIN["heads"], t_depth=PROTEIN["t_depth"],
                        c_depth=PROTEIN["c_depth"], frame_pool=True,
                        cross_depth=PROTEIN["cross_depth"], rel_frame=True,
                        equiv_head=True).eval()
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != PROTEIN["params"]:
        raise AssertionError(f"ProtNet at the headline width has {n_params} parameters")
    rng = np.random.default_rng(0)
    pairs = [synthetic_prot_pair(rng, PROTEIN["receptor"], PROTEIN["ligand"])
             for _ in range(PROTEIN["batch"])]
    batch = to_device(pad_prot_batch(pairs), device)
    x_in = ProtProjection(batch)(AffineT.identity((PROTEIN["batch"],), device=device))
    t_in = torch.full((PROTEIN["batch"],), 500, device=device)
    flops = protein_flops(PROTEIN["dim"], PROTEIN["t_depth"], PROTEIN["c_depth"],
                          PROTEIN["batch"], PROTEIN["receptor"], PROTEIN["ligand"],
                          PROTEIN["cross_depth"], frame_pool=True, rel_frame=True,
                          equiv_head=True)
    fwd = {}
    with torch.inference_mode():
        for name, bf16 in (("fp32", False), ("bf16", True)):
            model.bf16 = bf16
            ms = time_cuda(lambda: model(x_in, t_in), 10, warmup=3)
            fwd[name] = dict(ms=ms, tflops=flops / ms / 1e9)
    emit("protein_setup", forward_gflop=flops / 1e9,
         forward_ms_fp32=fwd["fp32"]["ms"], forward_tflops_fp32=fwd["fp32"]["tflops"],
         forward_ms_bf16=fwd["bf16"]["ms"], forward_tflops_bf16=fwd["bf16"]["tflops"],
         **PROTEIN)
    with torch.no_grad():
        model.head_out.weight.mul_(PROTEIN_HEAD_SCALE)
        model.head_out.bias.mul_(PROTEIN_HEAD_SCALE)
    weights = os.path.join(tmp, "init_head_scaled.pt")
    torch.save(model.state_dict(), weights)
    del model, x_in
    torch.cuda.empty_cache()

    obs.reset()
    samples = protein.SAMPLES
    try:
        for name, flags, per_pose, evals, launches in PROTEIN_ROWS:
            protein.SAMPLES = per_pose
            rec, out = run_captured(protein.main, PROTEIN_ARGV + flags + [
                "--test", "--ckpt", weights, "--out-dir", tmp])
            emit("protein_run", sampler=name, seconds=rec["sample_seconds"],
                 model_evals=rec["model_evals"], launches=rec["launches"], poses=rec["poses"],
                 samples_per_pose=per_pose, sweeps=rec["sweeps"], orth_err=rec["orth_err"],
                 det_err=rec["det_err"], angle_p50=float(np.median(rec["angles"])),
                 shift_p50=float(np.median(rec["shifts"])))
            if evals is None:  # Picard: one batched call a sweep, then the final estimate
                evals = max(rec["sweeps"]) + 1
            ok = (rec["finite"] and rec["orth_err"] < 1e-4 and rec["det_err"] < 1e-4
                  and rec["poses"] == PROTEIN["batch"] * per_pose
                  and rec["model_evals"] == evals and rec["launches"] == launches
                  and "no checkpoint found" not in out)
            if not ok:
                raise AssertionError(f"protein row {name}: "
                                     f"{ {k: v for k, v in rec.items() if k not in ('angles', 'shifts')} }")
    finally:
        protein.SAMPLES = samples
    total = kernel_launches()
    if total["igso3_logpdf_score"] == 0:
        raise AssertionError("the protein path launched no IGSO(3) kernel")
    return total


def protein_exact_resume(tmp: str) -> dict:
    """At the headline width with the production flags (bf16, fused Adam with
    bf16 moments, K = 8: one CUDA graph replayed a step): 2N replayed steps
    against N + save + restore + N, from the same init and batches.
    Returns the largest weight difference."""
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
    return {"resume_replayed": max(float((pa[k] - pb[k]).abs().max()) for k in pa)}


def phase_protein_train(tmp: str) -> dict:
    """Protein training at the headline width through ``protein.main``;
    returns each kernel's launches in this phase."""
    obs.reset()
    timed = PROTEIN_TRAIN["timed"]
    production = ["--opt-impl", "fused", "--opt-state-dtype", "bf16"]
    # (name, flags, warm-up steps: 10 at K = 1, two calls at K = 8)
    variants = [("bf16", ["--steps-per-call", "1"], 10),
                ("bf16_fused_bf16moments_k8", production + ["--steps-per-call", "8"], 16)]
    for name, extra, warm in variants:
        steps = warm + timed
        ckpt, log = os.path.join(tmp, name), os.path.join(tmp, f"{name}.jsonl")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = protein.main(PROTEIN_ARGV + extra + [
            "--steps", str(steps), "--print-every", str(steps), "--ckpt", ckpt, "--log", log])
        seconds = time.perf_counter() - t0
        rows = read_jsonl(log)
        sps = rows[-1]["steps_per_sec"]
        emit("protein_train", variant=name, steps=steps, timed_steps=timed,
             ms_per_step=1e3 / sps, steps_per_sec=sps, loss_last=rows[-1]["loss"],
             grad_norm=rows[-1]["grad_norm"], peak_memory_bytes=torch.cuda.max_memory_allocated(),
             seconds=seconds)
        if state.step != steps or latest_step(ckpt) != steps or not np.isfinite(rows[-1]["loss"]):
            raise AssertionError(f"protein_train {name}: step {state.step}, rows {rows}")
        del state
        shutil.rmtree(ckpt)

    # the loss falls (a row a call of 8: the last sub-step's loss), then --test
    # on the checkpoint
    ckpt, log = os.path.join(tmp, "fall"), os.path.join(tmp, "fall.jsonl")
    n = PROTEIN_TRAIN["fall_steps"]
    run_captured(protein.main, PROTEIN_ARGV + production + [
        "--steps-per-call", "8", "--steps", str(n), "--print-every", "1", "--ckpt", ckpt,
        "--log", log])
    rows = read_jsonl(log)
    first = float(np.mean([r["loss"] for r in rows[:5]]))
    last = float(np.mean([r["loss"] for r in rows[-5:]]))
    emit("protein_train", run="falling_loss", steps=n, rows=len(rows), loss_first_5_rows=first,
         loss_last_5_rows=last)
    if len(rows) != n // 8 or not all(np.isfinite(r["loss"]) for r in rows) or not last < first:
        raise AssertionError(f"protein_train: loss did not fall ({first} -> {last})")
    samples = protein.SAMPLES
    protein.SAMPLES = 1
    try:
        rec, out = run_captured(protein.main, PROTEIN_ARGV + [
            "--test", "--sampler", "ddim", "--ckpt", ckpt, "--out-dir", tmp])
    finally:
        protein.SAMPLES = samples
    emit("protein_train", run="test_on_checkpoint", sampler="ddim_50",
         seconds=rec["sample_seconds"], poses=rec["poses"],
         angle_p50=float(np.median(rec["angles"])), shift_p50=float(np.median(rec["shifts"])))
    if "no checkpoint found" in out or not rec["finite"] or rec["orth_err"] >= 1e-4:
        raise AssertionError("protein_train: --test did not evaluate the checkpoint")
    shutil.rmtree(ckpt)

    diffs = protein_exact_resume(tmp)
    emit("protein_train", run="exact_resume", n=PROTEIN_TRAIN["exact_n"], max_abs_diff=diffs,
         bit_identical=all(d == 0.0 for d in diffs.values()))
    if any(d != 0.0 for d in diffs.values()):
        raise AssertionError(f"protein_train: resumed weights differ: {diffs}")

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
    return kernel_launches()


def small_euler_agreement() -> None:
    """The Euler arms on the card against the same on the CPU, from one init
    and the same x_init and noise (drawn once on the CPU): the aircraft
    Euler chain (PlaneNet dim 64 / 2 layers, head scaled by 0.1,
    ProjectedGaussianDiffusion T = 20, B 4 x 32 points, Haar-Euler x_init);
    a protein Euler DDPM (ProtNet dim 64 / 4 heads / t_depth 2 / c_depth 3,
    se3=False, every flag, head scaled by 0.1, ProjectedEulerDiffusion
    T = 20, 4 pairs): each of its steps from the CPU chain's state.  The
    aircraft chain: 1e-3 of 1 + the state's largest entry; a protein step
    1e-4 of it.  The protein chain itself is not gated: an unclipped Euler
    chain of an untrained model grows by 1/sqrt(alpha_t) a step (to ~1e4
    here), its angles reach hundreds of radians, and the two devices' sin
    and cos of those part in the last bits, which the ligand's moved
    positions feed back; its free-running difference is printed.  Five
    lock-arm train steps for each arm (batch 32, the same t and noise, Adam
    lr 1e-3): each loss rtol 1e-4."""
    out = {}
    # aircraft Euler chain
    torch.manual_seed(21)
    init = PlaneNet(dim=64, heads=4, layers=2)
    with torch.no_grad():
        init.head.weight.mul_(0.1)
        init.head.bias.mul_(0.1)
    data = torch.from_numpy(np.random.default_rng(21).standard_normal((4, 32, 3)).astype(
        np.float32))
    x_init = torch.stack(rmat_to_euler(haar_rotations(torch.Generator().manual_seed(22), (4,))),
                         -1)
    noise = torch.randn(20, 4, 3, generator=torch.Generator().manual_seed(23))
    chains = {}
    for dev in ("cpu", "cuda"):
        proc = ProjectedGaussianDiffusion(20, device=dev)
        with torch.inference_mode():
            chains[dev] = proc.p_sample_loop(init.to(dev).eval(), None, (4, 3),
                                             projection=PointCloudProj(data.to(dev), so3=False),
                                             x_init=x_init.to(dev), noise=noise.to(dev)).cpu()
    ref = chains["cpu"]
    out["aircraft_chain_err"] = float((chains["cuda"] - ref).abs().max()) / (
        1.0 + float(ref.abs().max()))
    # protein Euler DDPM
    cfg = dict(dim=64, heads=4, t_depth=2, c_depth=3, se3=False, frame_pool=True, cross_depth=2,
               rel_frame=True, equiv_head=True)
    torch.manual_seed(24)
    pinit = ProtNet(**cfg)
    with torch.no_grad():
        pinit.head_out.weight.mul_(0.1)
        pinit.head_out.bias.mul_(0.1)
    rng = np.random.default_rng(24)
    batch_np = pad_prot_batch([synthetic_prot_pair(rng, 40 - i, 20 - i) for i in range(4)])
    proc_cpu = ProjectedEulerDiffusion.create(20, device="cpu")
    x0 = torch.randn(4, 6, generator=torch.Generator().manual_seed(25)) * proc_cpu._block_scale()
    pnoise = torch.randn(20, 4, 6, generator=torch.Generator().manual_seed(26))
    runs = {}
    for dev in ("cpu", "cuda"):
        proc = proc_cpu if dev == "cpu" else ProjectedEulerDiffusion.create(20, device=dev)
        model = ProtNet(**cfg)
        model.load_state_dict(pinit.state_dict())
        runs[dev] = (proc, model.to(dev).eval(),
                     ProtProjection(to_device(batch_np, dev), se3=False))
    (cproc, cmodel, cproj), (gproc, gmodel, gproj) = runs["cpu"], runs["cuda"]
    step_err, x_cpu, x_card = 0.0, x0, x0.cuda()
    with torch.inference_mode():
        for j, i in enumerate(range(19, -1, -1)):
            t = torch.full((4,), i)
            nxt = cproc.p_sample(cmodel, None, x_cpu, t, projection=cproj, noise=pnoise[j])
            anchored = gproc.p_sample(gmodel, None, x_cpu.cuda(), t.cuda(), projection=gproj,
                                      noise=pnoise[j].cuda()).cpu()
            step_err = max(step_err, float((anchored - nxt).abs().max())
                           / (1.0 + float(nxt.abs().max())))
            x_card = gproc.p_sample(gmodel, None, x_card, t.cuda(), projection=gproj,
                                    noise=pnoise[j].cuda())
            x_cpu = nxt
    ref = x_cpu
    out["protein_step_err"] = step_err
    out["protein_free_chain_err"] = float((x_card.cpu() - ref).abs().max()) / (
        1.0 + float(ref.abs().max()))
    out["protein_state_max"] = float(ref.abs().max())
    # lock-arm losses
    for param in ("so3", "euler"):
        args = lock.parse_args(["--param", param, "--timesteps", "1000"])
        gen = torch.Generator().manual_seed(27)
        batches = [lock.lock_batch(gen, 32, param) for _ in range(5)]
        ts = [torch.randint(0, args.timesteps, (32,), generator=gen) for _ in range(5)]
        proc_cpu = lock.build(args, "cpu")[1]
        if param == "so3":
            noises = [proc_cpu.sample_noise(gen, t) for t in ts]
        else:
            noises = [torch.randn(32, 3, generator=gen) for _ in ts]
        state0 = lock.build(args, "cpu")[0].state_dict()
        losses = {}
        for dev in ("cpu", "cuda"):
            model, proc = lock.build(args, dev)
            model.load_state_dict(state0)
            opt = make_optimizer(model.named_parameters(), 1e-3)
            step = make_dp_train_step(lock.make_loss_fn(model, proc), model, opt,
                                      skip_nonfinite=True)
            state = TrainState(model, opt, torch.Generator(device=dev))
            losses[dev] = []
            for b, t, n in zip(batches, ts, noises):
                state, m = step(state, (b.to(dev), t.to(dev), n.to(dev)))
                losses[dev].append(float(m["loss"]))
        out[f"lock_{param}_loss_rel_err"] = max(
            abs(a - b) / abs(a) for a, b in zip(losses["cpu"], losses["cuda"]))
        out[f"lock_{param}_losses_cuda"] = losses["cuda"]
    emit("small_agreement", run="euler", chain_tol=1e-3, step_tol=1e-4, loss_rtol=1e-4, **out)
    if not (out["aircraft_chain_err"] < 1e-3 and out["protein_step_err"] < 1e-4
            and out["lock_so3_loss_rel_err"] < 1e-4 and out["lock_euler_loss_rel_err"] < 1e-4):
        raise AssertionError(f"Euler arms: card and CPU disagree: {out}")


def phase_euler_aircraft(tmp: str) -> dict:
    """The aircraft Euler arm at full width through ``aircraft.main``: timed
    ``--bf16 --steps-per-call 8`` steps, a fp32 run whose loss must fall,
    and ``--test --euler-init haar`` on its checkpoint (a 1000-step chain
    a shape, gated finite and on SO(3)); returns each kernel's launches."""
    obs.reset()
    base = ["--dim", str(PATH["dim"]), "--heads", str(PATH["heads"]), "--layers",
            str(PATH["layers"]), "--batch", str(PATH["batch"]), "--samples", str(PATH["samples"]),
            "--timesteps", str(PATH["timesteps"])]
    steps = TRAIN["warmup"] + TRAIN["timed"]
    log = os.path.join(tmp, "euler_k8.jsonl")
    torch.cuda.reset_peak_memory_stats()
    state = aircraft.main(base + ["--bf16", "--steps-per-call", "8", "--steps", str(steps),
                                  "--print-every", str(TRAIN["print_every"]), "--ckpt",
                                  os.path.join(tmp, "euler_k8"), "--log", log])
    rows = read_jsonl(log)
    sps = rows[-1]["steps_per_sec"]
    emit("euler_aircraft", variant="bf16_k8", steps=steps, timed_steps=TRAIN["timed"],
         ms_per_step=1e3 / sps, steps_per_sec=sps, loss_last=rows[-1]["loss"],
         test_loss=rows[-1]["test_loss"], peak_memory_bytes=torch.cuda.max_memory_allocated())
    if state.step != steps or not all(np.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"euler_aircraft: step {state.step}, rows {rows}")

    ckpt, log = os.path.join(tmp, "euler_fall"), os.path.join(tmp, "euler_fall.jsonl")
    n = EULER["fall_steps"]
    run_captured(aircraft.main, base + ["--steps", str(n), "--print-every", "1", "--ckpt", ckpt,
                                        "--log", log])
    rows = read_jsonl(log)
    first = float(np.mean([r["loss"] for r in rows[:10]]))
    last = float(np.mean([r["loss"] for r in rows[-10:]]))
    emit("euler_aircraft", run="falling_loss", steps=n, loss_first_10=first, loss_last_10=last,
         test_loss_first=rows[0]["test_loss"], test_loss_last=rows[-1]["test_loss"])
    if len(rows) != n or not all(np.isfinite(r["loss"]) for r in rows) or not last < first:
        raise AssertionError(f"euler_aircraft: loss did not fall ({first} -> {last})")

    sampled = []
    sample_rotations, per_shape = aircraft.sample_rotations, aircraft.SAMPLES_PER_SHAPE

    def recorded(*a, **kw):
        rots = sample_rotations(*a, **kw)
        sampled.append(rots)
        return rots

    aircraft.sample_rotations, aircraft.SAMPLES_PER_SHAPE = recorded, 1
    try:
        t0 = time.perf_counter()
        res, out = run_captured(aircraft.main, base + [
            "--test", "--euler-init", "haar", "--max-shapes", str(EULER["test_shapes"]),
            "--ckpt", ckpt])
        sync()
        seconds = time.perf_counter() - t0
    finally:
        aircraft.sample_rotations, aircraft.SAMPLES_PER_SHAPE = sample_rotations, per_shape
    errs = check_rotations("euler_aircraft_test", sampled[0])
    emit("euler_aircraft", run="test_on_checkpoint", euler_init="haar", seconds=seconds,
         chains=len(sampled), samples=len(res), steps=PATH["timesteps"],
         median_angle=float(np.median(res)), **errs)
    if "no checkpoint found" in out or res.shape != (EULER["test_shapes"],) \
            or not np.isfinite(res).all() or "(eul)" not in out:
        raise AssertionError("euler_aircraft: --test did not evaluate the checkpoint")
    return kernel_launches()


def phase_euler_protein(tmp: str) -> dict:
    """The protein Euler arm (--se3 off) at the headline width: the forward
    in float32 and bf16, 16 + 96 steps with the production flags, then
    ``--test`` with the 1000-step ancestral chain (one sample a pose, the
    seeded init with its output layer scaled by PROTEIN_HEAD_SCALE);
    rotations gated on SO(3), shifts on finiteness."""
    device = torch.device("cuda")
    torch.manual_seed(0)
    with torch.device(device):
        model = ProtNet(dim=PROTEIN["dim"], heads=PROTEIN["heads"], t_depth=PROTEIN["t_depth"],
                        c_depth=PROTEIN["c_depth"], se3=False, frame_pool=True,
                        cross_depth=PROTEIN["cross_depth"], rel_frame=True,
                        equiv_head=True).eval()
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != PROTEIN["params"]:
        raise AssertionError(f"ProtNet(se3=False) at the headline width has {n_params} parameters")
    rng = np.random.default_rng(0)
    pairs = [synthetic_prot_pair(rng, PROTEIN["receptor"], PROTEIN["ligand"])
             for _ in range(PROTEIN["batch"])]
    batch = to_device(pad_prot_batch(pairs), device)
    x_in = ProtProjection(batch, se3=False)(torch.zeros(PROTEIN["batch"], 6, device=device))
    t_in = torch.full((PROTEIN["batch"],), 500, device=device)
    fwd = {}
    with torch.inference_mode():
        for name, bf16 in (("fp32", False), ("bf16", True)):
            model.bf16 = bf16
            out = model(x_in, t_in)
            if out.shape != (PROTEIN["batch"], 6) or not torch.isfinite(out).all():
                raise AssertionError(f"euler_protein: forward {name} gave {out.shape}")
            fwd[name] = time_cuda(lambda: model(x_in, t_in), 10, warmup=3)
    emit("euler_protein", params=n_params, forward_ms_fp32=fwd["fp32"],
         forward_ms_bf16=fwd["bf16"])
    with torch.no_grad():
        model.head_out.weight.mul_(PROTEIN_HEAD_SCALE)
        model.head_out.bias.mul_(PROTEIN_HEAD_SCALE)
    weights = os.path.join(tmp, "euler_init_head_scaled.pt")
    torch.save(model.state_dict(), weights)
    del model, x_in
    torch.cuda.empty_cache()

    obs.reset()
    steps = 16 + PROTEIN_TRAIN["timed"]
    ckpt, log = os.path.join(tmp, "euler_train"), os.path.join(tmp, "euler_train.jsonl")
    torch.cuda.reset_peak_memory_stats()
    state = protein.main(PROTEIN_EULER_ARGV + [
        "--opt-impl", "fused", "--opt-state-dtype", "bf16", "--steps-per-call", "8",
        "--steps", str(steps), "--print-every", str(steps), "--ckpt", ckpt, "--log", log])
    rows = read_jsonl(log)
    sps = rows[-1]["steps_per_sec"]
    emit("euler_protein", variant="bf16_fused_bf16moments_k8", steps=steps,
         timed_steps=PROTEIN_TRAIN["timed"], ms_per_step=1e3 / sps, steps_per_sec=sps,
         loss_last=rows[-1]["loss"], grad_norm=rows[-1]["grad_norm"],
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    if state.step != steps or latest_step(ckpt) != steps or not np.isfinite(rows[-1]["loss"]):
        raise AssertionError(f"euler_protein: step {state.step}, rows {rows}")
    del state
    shutil.rmtree(ckpt)

    samples = protein.SAMPLES
    protein.SAMPLES = 1
    try:
        rec, out = run_captured(protein.main, PROTEIN_EULER_ARGV + [
            "--test", "--ckpt", weights, "--out-dir", tmp])
    finally:
        protein.SAMPLES = samples
    emit("euler_protein", run="test_ancestral_1000", seconds=rec["sample_seconds"],
         model_evals=rec["model_evals"], poses=rec["poses"], finite=rec["finite"],
         orth_err=rec["orth_err"], det_err=rec["det_err"],
         angle_p50=float(np.median(rec["angles"])), shift_p50=float(np.median(rec["shifts"])),
         shift_max=float(np.max(rec["shifts"])))
    ok = (rec["arm"] == "eul" and rec["finite"] and rec["orth_err"] < 1e-4
          and rec["det_err"] < 1e-4 and rec["poses"] == PROTEIN["batch"]
          and rec["model_evals"] == PROTEIN["timesteps"] and "no checkpoint found" not in out)
    if not ok:
        raise AssertionError(f"euler_protein --test: "
                             f"{ {k: v for k, v in rec.items() if k not in ('angles', 'shifts')} }")
    return kernel_launches()


def phase_so3_toy(tmp: str) -> dict:
    """experiments/so3_toy.py: training at K = 16 (one CUDA graph replayed a
    step), then --test with the ancestral, DDIM-50 and probability-flow-50
    samplers over 512 chains; returns each kernel's launches."""
    obs.reset()
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
        rec, text = run_captured(so3_toy.main, [
            "--test", "--sampler", sampler, "--eval-batch", str(SUITES["eval_batch"]),
            "--ckpt", ckpt, "--out-dir", out])
        emit("so3_toy", run="test", sampler=sampler, seconds=rec["sample_seconds"],
             model_evals=rec["model_evals"], launches=rec["launches"],
             percentiles=rec["percentiles"])
        if "untrained" in text or not rec["finite"] or rec["count"] != SUITES["eval_batch"] \
                or rec["launches"] != 0:
            raise AssertionError(f"so3_toy --test {sampler}: {rec['percentiles']}")
    return kernel_launches()


def phase_lock(tmp: str) -> dict:
    """experiments/lock.py, both arms: eager steps (the non-finite skip
    waits for the device), then --test over 512 chains; returns each
    kernel's launches."""
    obs.reset()
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
        rec, text = run_captured(lock.main, ["--param", param, "--test", "--eval-batch",
                                             str(SUITES["eval_batch"]), "--ckpt", ckpt,
                                             "--out-dir", out])
        emit("lock", param=param, run="test", seconds=rec["sample_seconds"],
             axis_y_mean=rec["axis_y_mean"], angle_mean=rec["angle_mean"],
             in_range=rec["in_range"], count=rec["count"])
        if "untrained" in text or not rec["finite"] or rec["count"] != SUITES["eval_batch"]:
            raise AssertionError(f"lock --test {param}: {rec}")
    files = sorted(os.listdir(out))
    if files != ["torch_lock_euler.json", "torch_lock_samples_euler.npy",
                 "torch_lock_samples_so3.npy", "torch_lock_so3.json"]:
        raise AssertionError(f"lock records: {files}")
    return kernel_launches()


def small_jigsaw_agreement() -> None:
    """The jigsaw slice on the card against the same on the CPU, at size 128
    and batch 2 from one seeded init: the rendered images (every pixel
    equal), the CoordConv forward (1e-4 of the output's scale), the l2 loss
    at fixed t and noise (rtol 1e-4), and a 20-step projected ancestral
    chain from the same x_init and noise (1e-3 of 1 + the state's largest
    entry, as the other chains are held)."""
    size, b, steps = JIGSAW["size"], 2, 20
    jp = JigsawPuzzle(size=size, seed=31)
    row = torch.from_numpy(puzzle_rows([31], size)[0])
    gen = torch.Generator().manual_seed(32)
    x = torch.randn(16, 2, generator=gen) * 1.5
    t = torch.randint(0, steps, (b,), generator=gen)
    noise = torch.randn(b, 2, generator=gen)
    x_init = torch.randn(b, 2, generator=gen)
    chain_noise = torch.randn(steps, b, 2, generator=gen)
    torch.manual_seed(33)
    state0 = CoordConv(size=size).state_dict()
    out = {}
    for dev in ("cpu", "cuda"):
        model = CoordConv(size=size)
        model.load_state_dict(state0)
        model = model.to(dev)
        proc = ProjectedGaussianDiffusion(steps, loss_type="l2", device=dev)
        imgs = jp(x.to(dev))
        with torch.inference_mode():
            fwd = model(imgs[:b], t.to(dev))
            chain = proc.p_sample_loop(model, None, (b, 2), projection=jp, x_init=x_init.to(dev),
                                       noise=chain_noise.to(dev))
        loss = jigsaw.make_loss_fn(model, proc, b, size)(
            None, (row.to(dev), t.to(dev), noise.to(dev)))
        out[dev] = {"imgs": imgs.cpu(), "fwd": fwd.cpu(), "chain": chain.cpu(),
                    "loss": float(loss.detach())}
    cpu, card = out["cpu"], out["cuda"]
    res = {
        "pixels_differing": int((cpu["imgs"] != card["imgs"]).any(1).sum()),
        "forward_err": float((card["fwd"] - cpu["fwd"]).abs().max())
        / float(cpu["fwd"].abs().max()),
        "loss_rel_err": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
        "chain_err": float((card["chain"] - cpu["chain"]).abs().max())
        / (1.0 + float(cpu["chain"].abs().max())),
    }
    emit("small_agreement", run="jigsaw", forward_tol=1e-4, loss_rtol=1e-4, chain_tol=1e-3,
         **res)
    if not (res["pixels_differing"] == 0 and res["forward_err"] < 1e-4
            and res["loss_rel_err"] < 1e-4 and res["chain_err"] < 1e-3):
        raise AssertionError(f"jigsaw: card and CPU disagree: {res}")


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


def phase_jigsaw(tmp: str) -> dict:
    """experiments/jigsaw.py at full width: timed eager steps (ms, TFLOP/s
    against ``coordconv_flops``, peak memory), a run whose loss must fall,
    2N steps against N + save + restore + N to the bit, cuDNN determinism
    and its cost, then ``--test`` (the 1000-step chain over 64 samples) on
    the falling run's checkpoint; returns each kernel's launches."""
    obs.reset()
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

    ckpt, log = os.path.join(tmp, "jigsaw_fall"), os.path.join(tmp, "jigsaw_fall.jsonl")
    n = JIGSAW["fall_steps"]
    run_captured(jigsaw.main, base + ["--steps", str(n), "--print-every", "1", "--ckpt", ckpt,
                                      "--log", log])
    rows = read_jsonl(log)
    first = [r["loss"] for r in rows[:10]]
    last = [r["loss"] for r in rows[-10:]]
    emit("jigsaw", run="falling_loss", steps=n, losses_first_10=first, losses_last_10=last,
         loss_first_10=float(np.mean(first)), loss_last_10=float(np.mean(last)),
         steps_per_sec=rows[-1]["steps_per_sec"])
    if len(rows) != n or not all(np.isfinite(r["loss"]) for r in rows) \
            or not np.mean(last) < np.mean(first):
        raise AssertionError(f"jigsaw: loss did not fall ({first} -> {last})")

    n = JIGSAW["exact_n"]
    a, b = os.path.join(tmp, "jigsaw_2n"), os.path.join(tmp, "jigsaw_nn")
    quiet = base + ["--print-every", str(10 * n)]
    run_captured(jigsaw.main, quiet + ["--steps", str(2 * n), "--ckpt", a])
    run_captured(jigsaw.main, quiet + ["--steps", str(n), "--ckpt", b])
    run_captured(jigsaw.main, quiet + ["--steps", str(2 * n), "--ckpt", b, "--resume"])
    ra, rb = (torch.load(os.path.join(d, f"step_{2 * n:08d}.pt"), weights_only=True)
              for d in (a, b))
    diffs = [float((v - rb["params"][k]).abs().max()) for k, v in ra["params"].items()]
    diffs += [float((v - rb["opt_state"][m][k]).abs().max())
              for m in ("mu", "nu") for k, v in ra["opt_state"][m].items()]
    same_gen = torch.equal(ra["generator_state"], rb["generator_state"])
    emit("jigsaw", run="exact_resume", n=n, max_diff=max(diffs), same_generator=same_gen)
    if max(diffs) != 0.0 or not same_gen:
        raise AssertionError(f"jigsaw: N + save + restore + N differs from 2N by {max(diffs)}")
    det = jigsaw_determinism()
    emit("jigsaw", run="cudnn_determinism", steps=JIGSAW["det_steps"], **det)
    if not det["deterministic_same_bits"]:
        raise AssertionError(f"jigsaw: deterministic cuDNN steps differ run to run: {det}")

    rec, text = run_captured(jigsaw.main, base + [
        "--test", "--eval-batch", str(JIGSAW["eval_batch"]), "--ckpt", ckpt,
        "--out-dir", os.path.join(tmp, "jigsaw_out")])
    emit("jigsaw", run="test", seconds=rec["sample_seconds"], model_evals=rec["model_evals"],
         count=rec["count"], finite=rec["finite"], px=rec["px"], diverged=rec["diverged"],
         trained_steps=JIGSAW["fall_steps"])
    if "untrained" in text or not rec["finite"] or rec["count"] != JIGSAW["eval_batch"] \
            or rec["model_evals"] != JIGSAW["timesteps"]:
        raise AssertionError(f"jigsaw --test: {rec['px']}")
    return kernel_launches()


def phase_diagnostics(tmp: str) -> dict:
    """The compute-side diagnostics on the card: ``se3-path`` at its defaults
    (finite shifts, every pose on SO(3)), ``grad_check`` at its defaults (its
    loss must halve), and ``IGSO3xR3.log_prob`` over 50,000 poses against
    the CPU's inside kernel 1's gates; no figure.  Returns each kernel's
    launches."""
    obs.reset()
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
    lp = dist.log_prob(value)
    rot_lp = dist.igso3.log_prob(value.rot)
    sync()
    launched = obs.counter("ops.igso3.launches") - launches0
    cpu = IGSO3xR3.create(eps.cpu(), mean=AffineT(mean.rot.cpu(), mean.shift.cpu()),
                          shift_scale=75.0, device="cpu")
    value_cpu = AffineT(value.rot.cpu(), value.shift.cpu())
    lp_err, lp_gate = gate(lp.cpu(), cpu.log_prob(value_cpu), *LOGF_TOL)
    rot_err, rot_gate = gate(rot_lp.cpu(), cpu.igso3.log_prob(value_cpu.rot), *LOGF_TOL)
    emit("diagnostics", run="igso3xr3_log_prob", n=m, launches=launched, max_abs_err=lp_err,
         gate_ratio=lp_gate, rot_max_abs_err=rot_err, rot_gate_ratio=rot_gate,
         finite=bool(torch.isfinite(lp).all()))
    if launched != 2 or not (lp_gate <= 1.0 and rot_gate <= 1.0) or not torch.isfinite(lp).all():
        raise AssertionError(f"IGSO3xR3.log_prob: launches {launched}, gates {lp_gate} {rot_gate}")
    return kernel_launches()


def moe_routes(model: PlaneNet) -> list:
    """Wrap each MoE layer's router so that every call appends its
    (probs, expert) to the returned list."""
    seen = []
    for layer in model.encoder.layers:
        route = layer.moe.route

        def recorded(tokens, *args, route=route, **kwargs):
            out = route(tokens, *args, **kwargs)
            seen.append((out[0].detach().float().cpu(), out[2].cpu()))
            return out

        layer.moe.route = recorded
    return seen


def small_moe_agreement() -> None:
    """The MoE PlaneNet on the card against the CPU: dim 64, 4 heads, 2
    layers with 4 experts, B 4 x N 32 (T = 128 tokens a layer, C = 40),
    the same init, inputs, t and noise.  Forward within 1e-5 of its scale,
    the aircraft loss with the aux within rtol 1e-4, both dispatches, and
    the same expert for every token; tokens whose two top probabilities
    lie within 1e-6 of each other are counted, not gated."""
    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.standard_normal((4, 32, 3)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 100, 4))
    torch.manual_seed(21)
    init = PlaneNet(dim=64, heads=4, layers=2, moe_experts=4).state_dict()
    proc_cpu = ProjectedSO3Diffusion(100, device="cpu")
    noise = proc_cpu.sample_noise(torch.Generator().manual_seed(22), t)
    out = {}
    for dispatch in ("scatter", "onehot"):
        res = {}
        for dev in ("cpu", "cuda"):
            model = PlaneNet(dim=64, heads=4, layers=2, moe_experts=4, moe_dispatch=dispatch)
            model.load_state_dict(init)
            model = model.to(dev)
            routes = moe_routes(model)
            proc = proc_cpu if dev == "cpu" else ProjectedSO3Diffusion(100, device=dev)
            with torch.no_grad():
                fwd = model(x.to(dev), t.to(dev)).cpu()
                loss = aircraft.make_loss_fn(model, proc)(
                    None, (x.to(dev), t.to(dev), noise.to(dev)))
            res[dev] = (fwd, float(loss), routes[: len(model.encoder.layers)])
        fwd_err = float((res["cpu"][0] - res["cuda"][0]).abs().max())
        scale = float(res["cpu"][0].abs().max())
        loss_rel = abs(res["cpu"][1] - res["cuda"][1]) / abs(res["cpu"][1])
        differ, near_ties = 0, 0
        for (probs, e_cpu), (_, e_cuda) in zip(res["cpu"][2], res["cuda"][2]):
            top2 = probs.topk(2, dim=-1).values
            tie = (top2[:, 0] - top2[:, 1]) < 1e-6
            near_ties += int(tie.sum())
            differ += int(((e_cpu != e_cuda) & ~tie).sum())
        out[dispatch] = {"forward_err": fwd_err, "forward_scale": scale, "loss_cpu": res["cpu"][1],
                         "loss_cuda": res["cuda"][1], "loss_rel_err": loss_rel,
                         "routing_differs": differ, "near_ties": near_ties}
        if not (fwd_err <= 1e-5 * scale and loss_rel < 1e-4 and differ == 0):
            raise AssertionError(f"MoE {dispatch}: card and CPU disagree: {out[dispatch]}")
    emit("small_agreement", run="moe", forward_tol=1e-5, loss_rtol=1e-4, **out)


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


def phase_moe_aircraft(tmp: str) -> dict:
    """The Switch-MoE aircraft arm at full width through ``aircraft.main``
    (bench.py's moe_train_e4: PlaneNet d512 / h4 / l4 with 4 experts,
    scatter dispatch, batch 32 x 256 points, T = 8,192 tokens a layer,
    C = 2,560): MOE["steps"] replayed ``--bf16 --steps-per-call 8`` steps
    (ms, steps/s, peak memory, the loss on a fixed evaluation set falling
    from the init, expert fractions, the aux on the trained weights), the
    one-hot dispatch timed beside the scatter one, replayed and resumed
    steps against eager ones to the bit, then ``--test`` over 32 shapes;
    returns each kernel's launches."""
    obs.reset()
    base = ["--so3", "--dim", str(PATH["dim"]), "--heads", str(PATH["heads"]), "--layers",
            str(PATH["layers"]), "--batch", str(PATH["batch"]), "--samples", str(PATH["samples"]),
            "--timesteps", str(PATH["timesteps"]), "--moe-experts", str(MOE["experts"])]
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

    diffs = exact_resume_check(tmp, ["--so3", "--bf16", "--moe-experts", str(MOE["experts"])])
    emit("moe_aircraft", run="exact_resume", n=TRAIN["exact_n"], max_abs_diff=diffs,
         bit_identical=all(d == 0.0 for d in diffs.values()))
    if any(d != 0.0 for d in diffs.values()):
        raise AssertionError(f"moe_aircraft: weights differ from 2N eager steps: {diffs}")

    sampled = []
    sample_rotations, per_shape = aircraft.sample_rotations, aircraft.SAMPLES_PER_SHAPE

    def recorded(*a, **kw):
        rots = sample_rotations(*a, **kw)
        sampled.append(rots)
        return rots

    aircraft.sample_rotations, aircraft.SAMPLES_PER_SHAPE = recorded, 1
    try:
        t0 = time.perf_counter()
        res, out = run_captured(aircraft.main, base + [
            "--bf16", "--test", "--max-shapes", str(PATH["batch"]), "--ckpt", ckpt])
        sync()
        seconds = time.perf_counter() - t0
    finally:
        aircraft.sample_rotations, aircraft.SAMPLES_PER_SHAPE = sample_rotations, per_shape
    errs = check_rotations("moe_aircraft_test", sampled[0])
    emit("moe_aircraft", run="test_on_checkpoint", seconds=seconds, samples=len(res),
         steps=PATH["timesteps"], median_angle=float(np.median(res)), **errs)
    if "no checkpoint found" in out or res.shape != (PATH["batch"],) \
            or not np.isfinite(res).all():
        raise AssertionError("moe_aircraft: --test did not evaluate the checkpoint")
    return kernel_launches()


def phase_dsv2_aircraft(tmp: str) -> dict:
    """PlaneNet with the DeepSeek-V2 trunk at the dsv2lite-aircraft-train
    cell's size (DSV2: 1 dense + 4 MoE layers at DeepSeek-V2-Lite's widths,
    8 of 64 experts held, 64 clouds x 256 points, bf16, fused Adam at lr
    3e-4) through ``aircraft.main``: DSV2["steps"] replayed K = 8 steps (ms,
    peak memory, finite losses, the expert fractions), then one call of a
    fresh K = 8 step under the profiler: Adam's kernel once a step, the
    device kernels a step and the held experts' rows from the device
    counters; returns each kernel's launches."""
    obs.reset()
    arm = ["--so3", "--trunk", DSV2["trunk"], "--bf16", "--batch", str(DSV2["batch"]), "--samples",
           str(DSV2["samples"]), "--timesteps", "1000", "--opt-impl", "fused", "--lr", "3e-4",
           "--steps-per-call", "8"]
    ckpt, log = os.path.join(tmp, "dsv2"), os.path.join(tmp, "dsv2.jsonl")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, out = run_captured(aircraft.main, arm + ["--steps", str(DSV2["steps"]), "--print-every",
                                               str(DSV2["print_every"]), "--ckpt", ckpt, "--log", log])
    sync()
    seconds = time.perf_counter() - t0
    rows = read_jsonl(log)
    params = sum(p.numel() for p in state.model.parameters())
    launches = kernel_launches()
    emit("dsv2_aircraft", variant="bf16_k8", steps=DSV2["steps"], params=params,
         ms_per_step=1e3 / rows[-1]["steps_per_sec"], peak_memory_bytes=torch.cuda.max_memory_allocated(),
         losses=[r["loss"] for r in rows], test_loss=rows[-1]["test_loss"],
         expert_frac_max=rows[-1]["expert_frac_max"], seconds=seconds, launches=launches)
    if params != DSV2["params"] or state.step != DSV2["steps"] \
            or not all(np.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"dsv2_aircraft: {params} parameters, step {state.step}, rows {rows}")
    del state
    torch.cuda.empty_cache()

    args = aircraft.parse_args(arm)
    model, process = aircraft.build(args, torch.device("cuda"))
    opt = make_optimizer(model.named_parameters(), args.lr, impl="fused")
    step = make_dp_train_step(aircraft.make_loss_fn(model, process), model, opt, steps_per_call=8)
    st = TrainState(model, opt, torch.Generator(device="cuda").manual_seed(1))
    batches = torch.from_numpy(subsample_points(synthetic_planes(8 * DSV2["batch"], seed=3), DSV2["samples"], 5))
    batches = batches.reshape(8, DSV2["batch"], DSV2["samples"], 3).cuda()
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
    trunk = model.encoder.cfg
    rows = after["moe.rows"] - before["moe.rows"]
    expected = ((trunk.num_hidden_layers - trunk.first_k_dense_replace) * DSV2["batch"] * DSV2["samples"]
                * trunk.num_experts_per_tok * trunk.experts_held / trunk.n_routed_experts)
    emit("dsv2_aircraft", run="profiled_call", adam_launches_a_step=adam_a_step,
         moe_rows_kernels_a_step=moe_rows_a_step,
         device_ops_a_step=len(names) / 8, graph_kernels=after.get("train.graph_kernels"),
         moe_kernels_per_layer=after["moe.graph_kernels"] / after["moe.captures"],
         held_rows_a_step=rows / 8, expected_rows_a_step=expected,
         load_max_over_mean=(after["moe.rows_max"] - before["moe.rows_max"]) * trunk.experts_held / rows,
         loss=float(m["loss"]))
    if adam_a_step != 1 or not np.isfinite(float(m["loss"])):
        raise AssertionError(f"dsv2_aircraft: adam_update {adam_a_step} a step, loss {float(m['loss'])}")
    moe_layers = trunk.num_hidden_layers - trunk.first_k_dense_replace
    if moe_rows_a_step != 6 * moe_layers:
        raise AssertionError(f"dsv2_aircraft: {moe_rows_a_step} row-pass kernels a step, "
                             f"not 6 in each of {moe_layers} MoE layers")
    return launches


def phase_dp_world1(tmp: str) -> dict:
    """The multi-process code on the card at world size 1 over NCCL (a
    group made in this process): 16 replayed ``--bf16`` K = 8 aircraft
    steps at full width through ``make_dp_train_step(group=...)`` (the
    loss drawing the global batch's noise and taking the rank's slice)
    against the same steps without a group, to the bit, with the
    all-reduce issued while the step is captured; then
    ``--fsdp`` (FSDP2 over the group) for DP_WORLD1["fsdp_steps"] eager
    fp32 steps through ``aircraft.main`` against the plain eager steps,
    losses within rtol 1e-5 (both with the numpy loader: the native one's
    two threads hand out batches in the order they finish).  Returns each
    kernel's launches."""
    import torch.distributed as dist

    obs.reset()
    base = ["--so3", "--dim", str(PATH["dim"]), "--heads", str(PATH["heads"]), "--layers",
            str(PATH["layers"]), "--batch", str(PATH["batch"]), "--samples", str(PATH["samples"]),
            "--timesteps", str(PATH["timesteps"])]
    n = DP_WORLD1["fsdp_steps"]
    plain_log = os.path.join(tmp, "plain.jsonl")
    aircraft.main(base + ["--steps", str(n), "--print-every", "1", "--no-native", "--ckpt",
                          os.path.join(tmp, "plain"), "--log", plain_log])
    device = torch.device("cuda")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        args = aircraft.parse_args(base + ["--bf16"])
        loader = iter(BatchLoader(synthetic_planes(128, seed=0), PATH["batch"],
                                  samples=PATH["samples"], seed=0, device=device))
        batches = torch.stack([next(loader) for _ in range(DP_WORLD1["steps"])])
        captured = []
        all_reduce = dist.all_reduce

        def recorded(*a, **kw):
            captured.append(torch.cuda.is_current_stream_capturing())
            return all_reduce(*a, **kw)

        finals = {}
        for name, group in (("plain", None), ("all_reduce", dist.group.WORLD)):
            model, process = aircraft.build(args, device)
            opt = make_optimizer(model.named_parameters(), args.lr)
            state = TrainState(model, opt, torch.Generator(device=device).manual_seed(5))
            dist.all_reduce = recorded
            try:
                loss_fn = (aircraft.make_loss_fn(model, process) if group is None
                           else aircraft.make_global_loss_fn(model, process, group))
                step = make_dp_train_step(loss_fn, model, opt, steps_per_call=8, group=group)
                losses = []
                for i in range(0, DP_WORLD1["steps"], 8):
                    state, m = step(state, batches[i:i + 8])
                    losses.append(float(m["loss"]))
            finally:
                dist.all_reduce = all_reduce
            finals[name] = ({k: v.clone() for k, v in model.state_dict().items()}, losses)
        a, b = finals["plain"][0], finals["all_reduce"][0]
        diff = max(float((a[k] - b[k]).abs().max()) for k in a)
        emit("dp_world1", run="replayed_all_reduce", steps=DP_WORLD1["steps"], k=8,
             backend=dist.get_backend(), world_size=dist.get_world_size(),
             max_abs_diff=diff, bit_identical=diff == 0.0, losses=finals["all_reduce"][1],
             all_reduce_calls=len(captured), all_reduce_calls_while_capturing=sum(captured))
        if diff != 0.0 or sum(captured) != 1 or finals["plain"][1] != finals["all_reduce"][1]:
            raise AssertionError(f"dp_world1: replayed all-reduce step differs ({diff}) or the "
                                 f"capture held no all-reduce ({captured})")

        fsdp_log = os.path.join(tmp, "fsdp.jsonl")
        aircraft.main(base + ["--fsdp", "--steps", str(n), "--print-every", "1", "--no-native",
                              "--ckpt", os.path.join(tmp, "fsdp"), "--log", fsdp_log])
        plain = [r["loss"] for r in read_jsonl(plain_log)]
        fsdp = [r["loss"] for r in read_jsonl(fsdp_log)]
        rel = max(abs(p - f) / abs(p) for p, f in zip(plain, fsdp))
        emit("dp_world1", run="fsdp", steps=n, loss_plain=plain, loss_fsdp=fsdp,
             max_rel_err=rel, rtol=1e-5)
        if len(fsdp) != n or not rel < 1e-5:
            raise AssertionError(f"dp_world1: --fsdp losses part from the plain ones by {rel}")
    finally:
        dist.destroy_process_group()
    return kernel_launches()


def phase_bench() -> dict:
    """``bench.main(["--quick"])`` in this process (the JSON line it prints
    is passed on): the headline and its eleven rows finite and > 0, the
    MMD kernel launched 12 times (by mmd_eval, the only row that runs it),
    the headline's FlopCounterMode count beside 3x the closed-form forward.
    Returns each kernel's launches."""
    obs.reset()
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
    return launches


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


def phase_sweep(tmp: str) -> dict:
    """``sweep.main``: the lock driver (``--param so3``) over a two-point lr
    grid, one subprocess a point on the card, into a temporary ``--out``;
    both runs exit 0, ``summary.json`` ranks both by their mean loss, and
    the committed ``sweeps/`` is untouched.  The runs' launches happen in
    their own processes; this process's counts are returned."""
    obs.reset()
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
    return kernel_launches()


def phase_probe(tmp: str) -> dict:
    """``probe_protein`` at the headline width on a checkpoint written here
    (one replayed K = 8 call of the production flags through
    ``protein.main``): the checkpoint's step restored, all 20 MSEs finite,
    the zero predictor's shift MSE (a mean of squared unit normals) within
    0.7-1.3.  Returns each kernel's launches."""
    obs.reset()
    ckpt = os.path.join(tmp, "probe_ckpt")
    n = PROBE["train_steps"]
    run_captured(protein.main, PROTEIN_ARGV + [
        "--opt-impl", "fused", "--opt-state-dtype", "bf16", "--steps-per-call", "8",
        "--steps", str(n), "--print-every", str(n), "--ckpt", ckpt])
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
    return kernel_launches()


def timed(name: str, fn):
    t0 = time.perf_counter()
    out = fn()
    emit("phase_seconds", name=name, seconds=time.perf_counter() - t0)
    return out


def main() -> None:
    smi = timed("device", phase_device)
    sass = sass_counts(timed("build", phase_build))
    check = timed("kernel_check_igso3", phase_kernel_check)
    mmd_check = timed("kernel_check_mmd", phase_mmd_check)
    adam = timed("kernel_check_adam", phase_adam_check)
    moe_rows = timed("kernel_check_moe_rows", phase_moe_rows_check)
    timed("small_agreement_aircraft", small_cpu_agreement)
    timed("small_agreement_bingham", small_bingham_agreement)
    timed("small_agreement_train", small_train_agreement)
    aircraft_launches, fwd_ms = timed("aircraft_path", phase_path)
    bing = timed("bingham_path", phase_bingham_path)
    for name in ("igso3_logpdf_score", "gaussian_kernel_sum"):
        if bing[name] == 0:
            raise AssertionError(f"the Bingham path launched no {name} kernel")
    air_train = timed("aircraft_train", lambda: phase_aircraft_train(fwd_ms))
    bing_train = timed("bingham_train", phase_bingham_train)
    if air_train["igso3_logpdf_score"] == 0 or bing_train["gaussian_kernel_sum"] == 0:
        raise AssertionError(f"the training paths' launches: {air_train}, {bing_train}")
    timed("small_agreement_protein", small_protein_agreement)
    with tempfile.TemporaryDirectory() as tmp:
        prot = timed("protein_path", lambda: phase_protein_path(tmp))
        prot_train = timed("protein_train", lambda: phase_protein_train(tmp))
    timed("small_agreement_euler", small_euler_agreement)
    with tempfile.TemporaryDirectory() as tmp:
        euler_air = timed("euler_aircraft", lambda: phase_euler_aircraft(tmp))
        euler_prot = timed("euler_protein", lambda: phase_euler_protein(tmp))
        toy = timed("so3_toy", lambda: phase_so3_toy(tmp))
        lock_suite = timed("lock", lambda: phase_lock(tmp))
    timed("small_agreement_jigsaw", small_jigsaw_agreement)
    with tempfile.TemporaryDirectory() as tmp:
        jig = timed("jigsaw", lambda: phase_jigsaw(tmp))
        diag = timed("diagnostics", lambda: phase_diagnostics(tmp))
    if diag["igso3_logpdf_score"] == 0:
        raise AssertionError(f"the diagnostics path launched no igso3_logpdf_score: {diag}")
    timed("small_agreement_moe", small_moe_agreement)
    with tempfile.TemporaryDirectory() as tmp:
        moe = timed("moe_aircraft", lambda: phase_moe_aircraft(tmp))
        dsv2 = timed("dsv2_aircraft", lambda: phase_dsv2_aircraft(tmp))
        dp1 = timed("dp_world1", lambda: phase_dp_world1(tmp))
    bench_launches = timed("bench", phase_bench)
    with tempfile.TemporaryDirectory() as tmp:
        timed("sweep", lambda: phase_sweep(tmp))
        probe = timed("probe", lambda: phase_probe(tmp))
    by_path = {"aircraft": aircraft_launches, "bingham": bing,
               "aircraft_train": air_train, "bingham_train": bing_train,
               "protein": prot, "protein_train": prot_train, "euler_aircraft": euler_air,
               "euler_protein": euler_prot, "so3_toy": toy, "lock": lock_suite,
               "jigsaw": jig, "diagnostics": diag, "moe_aircraft": moe, "dsv2_aircraft": dsv2,
               "dp_world1": dp1,
               "bench": bench_launches, "probe": probe}
    launches = {k: sum(p[k] for p in by_path.values()) for k in aircraft_launches}
    main_n = PATH["batch"]
    tm, big = check["timing"][main_n], check["timing"][2**20]
    mid = check["timing"][BINGHAM_N]
    lp = check["timing"][f"{PATH['log_prob_n']} one sigma"]
    prot_n = check["timing"][PROTEIN["batch"]]
    big1 = check["timing"][f"{2**20} one sigma"]
    mt = mmd_check["timing"]
    kernels = [{
        "name": "igso3_logpdf_score",
        "route": "cuda",
        "source": "diffusion_extensions_tpu_torch/csrc/igso3_logpdf_score.cu",
        "replaces": "diffusion_extensions_tpu/ops/igso3_pallas.py:101",
        "launches": launches["igso3_logpdf_score"],
        "launches_by_path": {p: n["igso3_logpdf_score"] for p, n in by_path.items()},
        "max_abs_err": max(check["worst"]["logf_abs"], check["worst"]["score_abs"]),
        "ms": tm["ms"], "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
        "bound_by": tm["bound_by"], "library_ms": None, "n": main_n,
        "call_ms": tm["call_ms"], "plain_call_ms": tm["plain_call_ms"],
        "ms_1m": big["ms"], "plain_ms_1m": big["plain_ms"], "bound_ms_1m": big["bound_ms"],
        "call_ms_1m": big["call_ms"],
        "ms_20k": mid["ms"], "plain_ms_20k": mid["plain_ms"], "bound_ms_20k": mid["bound_ms"],
        "call_ms_20k": mid["call_ms"],
        "ms_50k_one_sigma": lp["ms"], "plain_ms_50k_one_sigma": lp["plain_ms"],
        "bound_ms_50k_one_sigma": lp["bound_ms"], "call_ms_50k_one_sigma": lp["call_ms"],
        "ms_1m_one_sigma": big1["ms"], "bound_ms_1m_one_sigma": big1["bound_ms"],
        "ms_16": prot_n["ms"], "plain_ms_16": prot_n["plain_ms"],
        "bound_ms_16": prot_n["bound_ms"], "call_ms_16": prot_n["call_ms"],
        "sass_instructions": sass["igso3_logpdf_score"],
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
        "launches_by_path": {p: n["gaussian_kernel_sum"] for p, n in by_path.items()},
        "max_abs_err": mmd_check["max_abs_err"],
        "ms": mt["ms"], "plain_ms": mt["plain_ms"], "bound_ms": mt["bound_ms"],
        "bound_by": mt["bound_by"], "library_ms": None, "n": mt["n"], "m": mt["m"],
        "max_rel_err": mmd_check["max_rel_err"], "pass": True,
        "sass_per_pair": sass["gaussian_kernel_sum"],
    }, {
        "name": "adam_update",
        "route": "cuda",
        "source": "diffusion_extensions_tpu_torch/csrc/adam_update.cu",
        "replaces": None,
        "launches": launches["adam_update"],
        "launches_by_path": {p: n["adam_update"] for p, n in by_path.items()},
        "max_abs_err": 0.0, "pass": True,
        **{f"{k}_{name}": v for name, row in adam.items() for k, v in row.items()
           if k in ("ms", "plain_ms", "library_ms", "bound_ms", "call_ms", "roofline_pct")},
        "sass_instructions": sass["adam_update"],
    }, {
        "name": "moe_rows",
        "route": "cuda",
        "source": "diffusion_extensions_tpu_torch/csrc/moe_rows.cu",
        "replaces": None,
        "launches": launches["moe_rows"],
        "launches_by_path": {p: n["moe_rows"] for p, n in by_path.items()},
        "pass": True,
        **{f"{k}_{name}_{case}": v for case, rows in moe_rows.items() for name, row in rows.items()
           if isinstance(row, dict) for k, v in row.items() if k in ("ms", "plain_ms", "bound_ms", "roofline_pct")},
        "sass_instructions": sass["moe_rows"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    # every path that trains on the card updates through Adam's kernel
    trains = ("aircraft_train", "bingham_train", "protein_train", "euler_aircraft",
              "euler_protein", "so3_toy", "lock", "jigsaw", "moe_aircraft", "dsv2_aircraft", "dp_world1",
              "bench",
              "probe")
    missing = [p for p in trains if by_path[p]["adam_update"] == 0]
    if missing:
        raise AssertionError(f"paths that trained without launching adam_update: {missing}")
    if by_path["dsv2_aircraft"]["moe_rows"] == 0:
        raise AssertionError("the DeepSeek-V2 trunk's path launched no moe_rows kernel")
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
