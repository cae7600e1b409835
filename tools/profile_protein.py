#!/usr/bin/env python3
"""Where the port's protein forward spends its time on the card.

    python tools/profile_protein.py [--iters 10] [--out DIR]

ProtNet at the headline width (dim 1024 / 8 heads / t_depth 12 / c_depth 8,
frame_pool, cross_depth 2, rel_frame, equiv_head; seeded init) on batch 16
of the protein driver's synthetic pairs (120 / 60 residues), at t = 500,
in float32 and under bf16 autocast.  After 3 warm-up forwards it times
``--iters`` forwards with CUDA events, then traces as many with
``torch.profiler`` and prints one JSON line per precision: ms a forward,
the device's busy ms (the sum of the kernels' durations) and idle share,
kernel launches a forward, and the twelve kernels with the most device
time.  Then the residue convolution alone (the receptor's, B 16 x 120)
three ways, forward and backward: ``_Conv3`` (one GEMM over the three
shifted copies, what the port runs) and ``F.conv1d`` on the same weights
with cuDNN's default and its deterministic algorithms; ms and whether two
runs give the same weight gradient, in float32 and bf16.  With ``--out``
the Chrome traces are written there.  Needs an NVIDIA GPU; imports torch,
numpy and the port only.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from diffusion_extensions_tpu_torch.data.pdb import (  # noqa: E402
    pad_prot_batch,
    synthetic_prot_pair,
    to_device,
)
from diffusion_extensions_tpu_torch.models.projections import ProtProjection  # noqa: E402
from diffusion_extensions_tpu_torch.models.protnet import ProtNet  # noqa: E402
from diffusion_extensions_tpu_torch.ops.se3 import AffineT  # noqa: E402


def run(model, x_in, t_in, bf16: bool, iters: int, out: str | None) -> dict:
    model.bf16 = bf16
    with torch.inference_mode():
        for _ in range(3):
            model(x_in, t_in)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            model(x_in, t_in)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / iters
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                model(x_in, t_in)
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kernels) / 1e3 / iters
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:12]
    name = "bf16" if bf16 else "fp32"
    if out:
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, f"protein_forward_{name}.json"))
    return {"precision": name, "ms_per_forward": ms, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / ms,
            "kernel_launches": sum(e.count for e in kernels) / iters,
            "top_kernels": [{"name": e.key[:80], "ms": e.device_time_total / 1e3 / iters,
                             "launches": e.count / iters} for e in top]}


def conv_compare(model, residues, iters: int) -> list[dict]:
    """The residue conv stack as the port runs it against ``F.conv1d``."""
    convs = model.res_conv.convs
    weights = [c.weight.detach().clone().requires_grad_() for c in convs]
    biases = [c.bias.detach().clone().requires_grad_() for c in convs]

    def stack(x, conv):
        h = torch.nn.functional.silu(conv(0, x))
        for i in range(1, len(weights) - 1):
            h = h + torch.nn.functional.silu(conv(i, h))
        return conv(len(weights) - 1, h)

    def port(i, x):
        c = convs[i]
        c.weight.data, c.bias.data = weights[i].data, biases[i].data
        return c(x)

    def cudnn(i, x):
        return torch.nn.functional.conv1d(x.transpose(1, 2), weights[i], biases[i],
                                          padding=1).transpose(1, 2)

    rows = []
    for bf16 in (False, True):
        for name, fn, det in (("gemm", port, False), ("cudnn", cudnn, False),
                              ("cudnn_deterministic", cudnn, True)):
            torch.backends.cudnn.deterministic = det
            params = weights + biases if fn is cudnn else list(model.res_conv.parameters())

            def step():
                for p in params:
                    p.grad = None
                with torch.autocast("cuda", dtype=torch.bfloat16, enabled=bf16):
                    out = stack(residues, fn)
                out.float().square().mean().backward()
                return [p.grad.clone() for p in params]

            first = step()
            same = all(torch.equal(a, b) for a, b in zip(first, step()))
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                step()
            end.record()
            torch.cuda.synchronize()
            rows.append({"conv": name, "precision": "bf16" if bf16 else "fp32",
                         "fwd_bwd_ms": start.elapsed_time(end) / iters,
                         "same_grads_twice": same})
    torch.backends.cudnn.deterministic = False
    return rows


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--out", type=str, default=None)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_protein: needs an NVIDIA GPU")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    device = torch.device("cuda")
    torch.manual_seed(0)
    with torch.device(device):
        model = ProtNet(dim=1024, heads=8, t_depth=12, c_depth=8, frame_pool=True,
                        cross_depth=2, rel_frame=True, equiv_head=True).eval()
    rng = np.random.default_rng(0)
    batch = to_device(pad_prot_batch([synthetic_prot_pair(rng) for _ in range(16)]), device)
    x_in = ProtProjection(batch)(AffineT.identity((16,), device=device))
    t_in = torch.full((16,), 500, device=device)
    for bf16 in (False, True):
        print(json.dumps(run(model, x_in, t_in, bf16, args.iters, args.out)), flush=True)
    for row in conv_compare(model.train(), batch.receptor.residues, args.iters):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
