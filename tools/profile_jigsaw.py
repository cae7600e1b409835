#!/usr/bin/env python3
"""Where the port's jigsaw train step and sampler step spend their time on
the card.

    python tools/profile_jigsaw.py [--steps 10] [--out DIR]

The train step at the jigsaw driver's width (CoordConv size 128, batch 256,
T = 1000, seeded init, a fresh puzzle a step) under three cuDNN settings:
the jigsaw driver's (deterministic algorithms), cuDNN's defaults, and the
deterministic algorithms chosen by cuDNN's benchmark; then one step of the
``--test`` chain (a forward over 64 samples).  After 5 warm-up steps it
times ``--steps`` steps with the host's clock around a synchronise, then
traces the same number with ``torch.profiler`` and prints one JSON line a
variant: ms a step, the device's busy ms a step and idle share, kernel
launches a step, the device ms a step of cuDNN's FFT convolutions, of its
implicit-GEMM convolutions and of the rest, and the eight kernels with the
most device time.  The idle share is that of the traced window (its own
wall time).  With ``--out`` the Chrome traces are written there.  Needs an
NVIDIA GPU; imports torch, numpy and the port only.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from diffusion_extensions_tpu_torch.data.jigsaw import JigsawPuzzle, puzzle_rows  # noqa: E402
from diffusion_extensions_tpu_torch.experiments import jigsaw  # noqa: E402
from diffusion_extensions_tpu_torch.parallel.dp import make_dp_train_step  # noqa: E402
from diffusion_extensions_tpu_torch.train.optim import make_optimizer  # noqa: E402
from diffusion_extensions_tpu_torch.train.state import TrainState  # noqa: E402

# variant -> (cudnn.deterministic, cudnn.benchmark); "sample" is the --test chain's step
VARIANTS = {"deterministic": (True, False), "default": (False, False),
            "deterministic_benchmark": (True, True), "sample": (False, False)}
WARMUP = 5


def _kind(name: str) -> str:
    """cuDNN's FFT convolution (its transforms, pointwise products and
    complex GEMMs), its implicit-GEMM convolution, or anything else."""
    n = name.lower()
    if "fft" in n or "cf32" in n or "region_transform" in n:
        return "conv_fft"
    if "xmma" in n or "implicit" in n or "conv" in n or "winograd" in n:
        return "conv_gemm"
    return "other"


def run(name: str, steps: int, out: str | None) -> dict:
    det, bench = VARIANTS[name]
    device = torch.device("cuda")
    args = jigsaw.parse_args([])
    model, process = jigsaw.build(args, device)
    rows = torch.from_numpy(puzzle_rows(jigsaw.step_seeds(0, 0, WARMUP + 2 * steps))).to(device)
    if name == "sample":
        model.eval()
        jp = JigsawPuzzle(seed=1234)
        x = torch.randn(args.eval_batch, 2, device=device)
        t = torch.full((args.eval_batch,), 500, device=device)

        def advance(i: int):
            with torch.inference_mode():
                process.p_sample(model, None, x, t, projection=jp)
    else:
        opt = make_optimizer(model.named_parameters(), args.lr)
        state = TrainState(model, opt, torch.Generator(device=device).manual_seed(0))
        step = make_dp_train_step(jigsaw.make_loss_fn(model, process, args.batch, args.size),
                                  model, opt)

        def advance(i: int):
            step(state, rows[i])

    before = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det, bench
    try:
        for i in range(WARMUP):
            advance(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(WARMUP, WARMUP + steps):
            advance(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        torch.cuda.reset_peak_memory_stats()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for i in range(WARMUP + steps, WARMUP + 2 * steps):
                advance(i)
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3 / steps
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = before
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3 / steps
    by_kind: dict[str, float] = {}
    for e in kernels:
        kind = _kind(e.key)
        by_kind[kind] = by_kind.get(kind, 0.0) + e.device_time_total / 1e3 / steps
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:8]
    if out:
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, f"jigsaw_{name}.json"))
    return {"variant": name, "steps": steps, "ms_per_step": wall_ms,
            "traced_ms_per_step": traced_ms, "device_busy_ms_per_step": busy_ms,
            "device_idle_share": 1.0 - busy_ms / traced_ms,
            "kernel_launches_per_step": sum(e.count for e in kernels) / steps,
            "device_ms_by_kind": by_kind, "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "top_kernels": [{"name": e.key[:90], "ms_per_step": e.device_time_total / 1e3 / steps,
                             "launches_per_step": e.count / steps} for e in top]}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("variants", nargs="*", default=list(VARIANTS))
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_jigsaw: needs an NVIDIA GPU")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for name in args.variants:
        print(json.dumps(run(name, args.steps, args.out)), flush=True)


if __name__ == "__main__":
    main()
