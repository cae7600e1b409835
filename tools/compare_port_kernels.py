#!/usr/bin/env python3
"""Time the port's two CUDA kernels in two checkouts on one NVIDIA GPU.

    python tools/compare_port_kernels.py PARENT_DIR [CHANGE_DIR]

Each checkout (a directory holding ``diffusion_extensions_tpu_torch/``;
CHANGE_DIR defaults to this one) is timed in a process of its own, in the
order parent, change, change, parent, so that both see the same card in one
call.  Per process, through the wrappers a user calls:

* ``igso3_logpdf_score`` at n = 32 and n = 20,000 (dense sigma), n = 50,000
  with one sigma (the ``log_prob`` shape) and n = 2^20 (dense): ``ms`` is the
  device time per call (100 calls captured in a CUDA graph, replayed),
  ``call_ms`` the time per eager call from Python (CUDA events around 1000
  back-to-back calls);
* ``gaussian_kernel_sum`` at 20,000 x 20,000 rotations: ms per sum (CUDA
  events, 20 sums).

Prints one JSON line per process and nvidia-smi's name and power limit.
To make the parent: ``git archive <commit> | tar -x -C <ignored dir>``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

CHILD = r"""
import json, sys
import numpy as np
import torch
from diffusion_extensions_tpu_torch.ops import igso3_cuda, mmd_cuda
from diffusion_extensions_tpu_torch.ops.so3 import exp_skewvec


def time_cuda(fn, iters, warmup=10):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_graph(fn, reps=100, replays=10):
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
    torch.cuda.synchronize()
    return time_cuda(graph.replay, replays, warmup=0) / reps


out = {}
rng = np.random.default_rng(1)
for n, one_sigma in ((32, False), (20_000, False), (50_000, True), (2**20, False)):
    t = torch.from_numpy(rng.uniform(0.0, np.pi, n).astype(np.float32)).cuda()
    s = torch.from_numpy(rng.uniform(0.02, 1.5, n).astype(np.float32)).cuda()
    if one_sigma:
        s = torch.tensor(0.5, device="cuda")
    fn = lambda: igso3_cuda.igso3_logpdf_score(t, s)
    key = f"igso3 n={n}" + (" one sigma" if one_sigma else "")
    out[key] = {"ms": time_graph(fn), "call_ms": time_cuda(fn, 1000)}


def rotations(n, seed, scale=1.0):
    v = np.random.default_rng(seed).standard_normal((n, 3)).astype(np.float32) * scale
    return exp_skewvec(torch.from_numpy(v).cuda())


x, y = rotations(20_000, 9), rotations(20_000, 10, 0.7)
out["mmd 20000x20000"] = {"ms": time_cuda(lambda: mmd_cuda.gaussian_kernel_sum(x, y), 20, 3),
                          "sum": float(mmd_cuda.gaussian_kernel_sum(x, y))}
print(json.dumps(out))
"""


def main() -> None:
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    parent = os.path.abspath(sys.argv[1])
    change = os.path.abspath(sys.argv[2] if len(sys.argv) > 2
                             else os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for name, root in (("parent", parent), ("change", change), ("change", change),
                       ("parent", parent)):
        res = subprocess.run([sys.executable, "-c", CHILD], cwd=root, capture_output=True,
                             text=True, env={**os.environ, "PYTHONPATH": root})
        if res.returncode != 0:
            raise SystemExit(f"{name} ({root}) failed:\n{res.stderr}")
        print(json.dumps({"checkout": name, **json.loads(res.stdout.strip().splitlines()[-1])}),
              flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
