#!/usr/bin/env python3
"""Where the port's aircraft train step spends its time on the card.

    python tools/profile_train_step.py [--steps 16] [--out DIR]

For each variant of the step at full width (PlaneNet dim 512 / 4 heads / 4
layers, batch 32 x 256, T = 1000, synthetic clouds): the optimizer's plain
chain or fused sweep, fp32 or the encoder under bf16 autocast, eager steps
or one CUDA graph replayed a step (``steps_per_call`` 8), and the Switch-MoE
arm (4 experts, scatter or one-hot dispatch, bf16, replayed).  Spans
(``obs``) are on, so every step carries its device stamps.  After 24 warm-up
steps it times ``--steps`` steps with the host's clock around a synchronise,
then traces the same number with ``torch.profiler`` and prints one JSON line
per variant: ms a step, the device's busy ms a step (the union of the
device's operation intervals, as ``benchmark/harness/trace.py`` takes it:
overlapping kernels count once) and idle share, kernel launches a step (the
stamps apart), the ten kernels with the most device time, and the phase
split of the timed steps from the spans (median device ms a step of each
span, device us between steps, host us a replay).  With ``--out`` the
Chrome traces are written there.  Needs an NVIDIA GPU; imports torch, numpy,
the port and the benchmark's trace arithmetic only.
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

from benchmark.harness.trace import busy  # noqa: E402
from diffusion_extensions_tpu_torch import obs  # noqa: E402
from diffusion_extensions_tpu_torch.data.shapenet import BatchLoader, synthetic_planes  # noqa: E402
from diffusion_extensions_tpu_torch.experiments import aircraft  # noqa: E402
from diffusion_extensions_tpu_torch.parallel.dp import make_dp_train_step  # noqa: E402
from diffusion_extensions_tpu_torch.train.optim import make_optimizer  # noqa: E402
from diffusion_extensions_tpu_torch.train.state import TrainState  # noqa: E402

VARIANTS = {
    "fp32": ([], 1), "fused": (["--opt-impl", "fused"], 1), "k8": ([], 8),
    "fused_k8": (["--opt-impl", "fused"], 8), "bf16_k8": (["--bf16"], 8),
    "bf16_fused_k8": (["--bf16", "--opt-impl", "fused"], 8),
    "moe_bf16_k8": (["--bf16", "--moe-experts", "4"], 8),
    "moe_onehot_bf16_k8": (["--bf16", "--moe-experts", "4", "--moe-dispatch", "onehot"], 8),
}
WARMUP = 24


def run(name: str, steps: int, out: str | None) -> dict:
    flags, k = VARIANTS[name]
    args = aircraft.parse_args(["--so3", *flags])
    device = torch.device("cuda")
    model, process = aircraft.build(args, device)
    opt = make_optimizer(model.named_parameters(), args.lr, impl=args.opt_impl)
    step = make_dp_train_step(aircraft.make_loss_fn(model, process), model, opt, steps_per_call=k)
    state = TrainState(model, opt, torch.Generator(device=device).manual_seed(0))
    loader = iter(BatchLoader(synthetic_planes(256, seed=0), args.batch, samples=args.samples,
                              seed=0, device=device))

    def advance(n: int):
        nonlocal state
        for _ in range(n // k):
            batch = next(loader) if k == 1 else torch.stack([next(loader) for _ in range(k)])
            state, metrics = step(state, batch)
        return metrics

    advance(WARMUP)
    torch.cuda.synchronize()
    obs.reset()
    t0 = time.perf_counter()
    advance(steps)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    phases = obs.summary(obs.snapshot())
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        loss = float(advance(steps)["loss"])
        torch.cuda.synchronize()
    # the dxt:: ranges' projections on the device's timeline are no operations
    ops = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.key.startswith("dxt::")]
    kernels = [e for e in ops if "obs_stamp" not in e.key]
    stamps = sum(e.count for e in ops if "obs_stamp" in e.key)
    device = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA and not e.name().startswith("dxt::")]
    busy_ms = busy(device) / 1e6 / steps
    launches = sum(e.count for e in kernels) / steps
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:10]
    if out:
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, f"train_step_{name}.json"))
    return {"variant": name, "steps": steps, "ms_per_step": wall_ms,
            "device_busy_ms_per_step": busy_ms, "device_idle_share": 1.0 - busy_ms / wall_ms,
            "kernel_launches_per_step": launches, "stamps_per_step": stamps / steps, "loss": loss,
            "phases_ms": phases["device_ms"], "between_steps_us": phases["between_steps_us"],
            "host_us": phases["host_us"],
            "top_kernels": [{"name": e.key[:70], "ms_per_step": e.device_time_total / 1e3 / steps,
                             "launches_per_step": e.count / steps} for e in top]}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=16)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("variants", nargs="*", default=list(VARIANTS))
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train_step: needs an NVIDIA GPU")
    obs.enable()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for name in args.variants:
        print(json.dumps(run(name, args.steps, args.out)), flush=True)


if __name__ == "__main__":
    main()
