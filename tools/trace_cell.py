#!/usr/bin/env python3
"""A benchmark cell's train step with spans on, on the card: what the spans
cost, the step's phase split from them, and a profiled stretch cut into
phases at the stamp kernels.

    python tools/trace_cell.py --workload aircraft-train --seed 1 \\
        [--window 10] [--rounds 3] [--settle 30] [--trace-calls 10]

It builds the cell's train state twice from the seed, as the benchmark's
training loop does (``benchmark/loops/train.py`` ``build`` and
``step_function``): first after ``obs.enable()``, then with spans off
(``obs.disable()``), so that only the first step's graph holds stamps.  After a warm call of each
and ``--settle`` seconds of calls, it runs closed-loop windows of
``--window`` seconds over the cell's pool (the host at most one call
ahead), off and on in turns (off, on, on, off, ...) for ``--rounds``
rounds, spans off (``obs.disable()``) in the off windows; each window's ms
a step is printed, and the cost of spans on each round's pair of windows.  The spans of the on windows give the phase split:
median device ms a step of each span, device us between two steps, host us
a replay.  Then ``--trace-calls`` calls of the on step run under
``torch.profiler``: the trace is cut into phases at the stamp kernels (six
a step; sixteen for the DeepSeek-V2 trunk's cell), and each phase's device
operations a step, busy time a step (the union of their intervals), time
from stamp to stamp and five biggest kernels are printed beside the ring's
medians of the same calls (for the DeepSeek-V2 trunk's cell the forward
is cut further, at its FFN spans: ``phases_of``); the stretch's idle time
is split by the innermost ``dxt::`` host range over the middle of each gap
("outside the program" where none is).  One JSON line goes to standard
output, the tables to standard error.  Where the spans-off state would
not fit beside the spans-on one (the card's free memory under the first
build's peak: kimilinear-aircraft-train, ~50 GiB), the spans-on state
alone is timed and the cost of spans is left out (null).  Needs an NVIDIA
GPU; imports torch,
numpy, the port and the benchmark's harness only.
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import subprocess
import sys
import time
from collections import defaultdict

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import cell, files, util  # noqa: E402
from benchmark.harness.trace import union  # noqa: E402
from benchmark.loops import train  # noqa: E402
from diffusion_extensions_tpu_torch import obs  # noqa: E402

# what lies between a step's stamps, in their order (obs: a start that meets
# the end before it shares its stamp)
PHASES = ["train.step before process.noise", "process.noise", "model.forward", "train.backward",
          "train.optimizer", "between steps"]
CHILDREN = PHASES[1:5]  # the spans inside train.step


def phases_of(cfg: dict) -> list:
    """PHASES of a cell's model: with the DeepSeek-V2 trunk
    (``planenet_dsv2``) ``model.forward`` is cut at the stamps of its
    ``ffn.dense`` and ``moe.l<i>`` spans (each stamped at both ends): the
    embedding and each layer's attention before its FFN, the FFN, and
    after the trunk (the final norm, the pool, the head and the loss).
    With the Kimi Linear trunk (``planenet_kimi``) a KDA layer is cut at its
    ``kda.l<i>`` span too: the norm before it (the embedding too in layer
    0), the mixer, and the residual and the norm after it; an MLA layer's
    attention lies between the FFNs' spans as in the DeepSeek-V2 trunk."""
    if cfg["family"] not in ("planenet_dsv2", "planenet_kimi"):
        return PHASES
    kda = set(cfg["linear_attn_config"]["kda_layers"]) if cfg["family"] == "planenet_kimi" else set()
    trunk = []
    for i in range(cfg["num_hidden_layers"]):
        first = "embedding + " if i == 0 else ""
        if i + 1 in kda:
            trunk += [f"{first}layer {i} norm", f"kda.l{i}", f"layer {i} residual + norm"]
        else:
            trunk.append(f"{first}layer {i} attention")
        trunk.append("ffn.dense" if i < cfg["first_k_dense_replace"] else f"moe.l{i}")
    return PHASES[:2] + trunk + ["after the trunk"] + PHASES[3:]


def build(name: str, seed: int, device: torch.device):
    """The cell's step function, state and pool, and its steps a call."""
    cfg, traffic = cell.load(name)[1:]
    fam = files.family(cfg["family"])
    b = train.build(cfg, traffic, seed, device, fam)
    step_fn = train.step_function(cfg, traffic, b)
    state, pool = b["state"], b["pool"]
    state, _ = step_fn(state, pool)  # the eager step, the capture, the replays
    torch.cuda.synchronize()
    return step_fn, state, pool, traffic["steps_per_call"]


def fits_twice(device) -> bool:
    """Whether a second build, as large at its peak as the first, fits in
    what the card has free beside the first's state."""
    free = torch.cuda.mem_get_info(device)[0] + torch.cuda.memory_reserved(device) \
        - torch.cuda.memory_allocated(device)
    return torch.cuda.max_memory_allocated(device) < free


def window(run, seconds: float, device) -> float:
    """ms a step over closed-loop calls for ``seconds``."""
    step_fn, state, pool, k = run
    marks, calls = util.Marks(device), 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    marks.mark()
    while True:
        state, _ = step_fn(state, pool)
        marks.mark()
        calls += 1
        marks.wait(calls - 1)
        if time.perf_counter() - t0 >= seconds:
            break
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / (calls * k)


def _events(prof):
    """(device operations, host events) as (name, start_ns, end_ns); the
    ``dxt::`` ranges' projections on the device's timeline are no
    operations and are left out."""
    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        row = (ev.name(), s, s + ev.duration_ns())
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            host.append(row)
        elif not row[0].startswith("dxt::"):
            dev.append(row)
    return sorted(dev, key=lambda r: r[1]), host


def cut(dev: list, phases: list = PHASES) -> dict:
    """The stretch's device operations split into ``phases`` at the stamps.  A
    step's stamps are those between two host copies into the graph's batch
    (``Memcpy DtoD``: inside a graph a copy runs as a kernel); a step whose
    stamps the trace did not hold all of is left out."""
    steps, current, copied = [], [], False
    for row in dev:
        if row[0].startswith("Memcpy DtoD"):
            copied = True
        elif "obs_stamp" in row[0]:
            if copied and current:
                steps.append(current)
                current = []
            current.append(row)
            copied = False
    steps.append(current)
    bounds = []  # (start, end, phase) of each whole step's phases, in order
    for i, stamps in enumerate(steps):
        if len(stamps) != len(phases):
            continue
        after = steps[i + 1][0][1] if i + 1 < len(steps) else None
        ends = [s[1] for s in stamps[1:]] + [after]
        bounds += [(s[1], e, phase) for phase, s, e in zip(phases, stamps, ends) if e is not None]
    starts = [b[0] for b in bounds]
    ops = defaultdict(list)
    for row in dev:
        i = bisect.bisect_right(starts, row[1]) - 1
        if "obs_stamp" not in row[0] and i >= 0 and row[1] < bounds[i][1]:
            ops[bounds[i][2]].append(row)
    out = {}
    for phase in phases:
        walls = [e - s for s, e, p in bounds if p == phase]
        n = max(len(walls), 1)
        by_name = defaultdict(float)
        for name, s, e in ops[phase]:
            by_name[name] += (e - s) / 1e6 / n
        busy = sum(e - s for s, e in union([(s, e) for _, s, e in ops[phase]]))
        out[phase] = {"steps": len(walls), "kernels": len(ops[phase]) / n, "busy_ms": busy / 1e6 / n,
                      "stamp_to_stamp_ms": statistics.median(walls) / 1e6 if walls else None,
                      "top": sorted(([k[:70], v] for k, v in by_name.items()), key=lambda x: -x[1])[:5]}
    out["steps dropped"] = sum(len(s) != len(phases) for s in steps)
    return out


def idle_by_span(dev: list, host: list) -> dict:
    """Idle seconds of the stretch by the innermost ``dxt::`` host range
    over the middle of each gap between the device's busy intervals."""
    ranges = sorted((r for r in host if r[0].startswith("dxt::")), key=lambda r: r[1])
    starts = [r[1] for r in ranges]
    merged = union([(s, e) for _, s, e in dev])
    out = defaultdict(float)
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid, best = (a + b) / 2, None
        for name, s, e in ranges[:bisect.bisect_right(starts, mid)][::-1][:200]:
            if e >= mid and (best is None or e - s < best[1]):
                best = (name, e - s)
        out[best[0] if best else "outside the program"] += (b - a) / 1e9
    return dict(out)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--window", type=float, default=8.0)
    p.add_argument("--rounds", type=int, default=6)
    p.add_argument("--settle", type=float, default=60.0)
    p.add_argument("--trace-calls", type=int, default=10)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("trace_cell: needs an NVIDIA GPU")
    device = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    phase_names = phases_of(cell.load(args.workload)[1])
    obs.enable(device)
    on = build(args.workload, args.seed, device)
    capture = obs.snapshot()["counters"]
    off = None
    if fits_twice(device):
        obs.disable()
        off = build(args.workload, args.seed, device)
        obs.enable()
    window(on, args.settle, device)
    ms = {"off": [], "on": []}
    obs.reset()
    for r in range(args.rounds):
        for side in (("off", "on") if r % 2 == 0 else ("on", "off")):
            if side == "off" and off is None:
                continue
            (obs.enable if side == "on" else obs.disable)()
            ms[side].append(window(on if side == "on" else off, args.window, device))
    snap = obs.snapshot()
    spans = obs.summary(snap)
    dm = spans["device_ms"]
    on_ms = statistics.median(ms["on"])
    off_ms = statistics.median(ms["off"]) if ms["off"] else None
    children = sum(dm[n] for n in CHILDREN)
    obs.reset()
    obs.enable()
    step_fn, state, pool, k = on
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.trace_calls):
            state, _ = step_fn(state, pool)
        torch.cuda.synchronize()
    stretch_spans = obs.summary(obs.snapshot())
    dev, host = _events(prof)
    phases = cut(dev, phase_names)
    for name in phase_names:
        if name in dm:
            phases[name]["ring_ms_in_stretch"] = stretch_spans["device_ms"][name]
            phases[name]["ring_ms_untraced"] = dm[name]
    idle = idle_by_span(dev, host)
    out = {"workload": args.workload, "seed": args.seed, "card": card, "off_ms": ms["off"], "on_ms": ms["on"],
           "cost_pct": 100 * (on_ms / off_ms - 1) if off_ms else None,
           "paired_cost_pct": [100 * (a / b - 1) for a, b in zip(ms["on"], ms["off"])], "spans": spans,
           "children_ms": children, "step_ms": dm["train.step"],
           "children_share_of_step_pct": 100 * children / dm["train.step"],
           "step_plus_between_ms": dm["train.step"] + spans["between_steps_us"] / 1e3,
           "step_plus_between_vs_off_pct": 100 * ((dm["train.step"] + spans["between_steps_us"] / 1e3)
                                                  / off_ms - 1) if off_ms else None,
           "host_replay_us_quartiles": [q / 1e3 for q in statistics.quantiles(obs.host_ns(snap, "train.replay"), n=4)],
           "capture_counters": capture, "stretch": phases, "stretch_idle_s": idle}
    print(f"{args.workload} seed {args.seed} on {card}: ms a step off {ms['off']} on {ms['on']}, "
          f"cost {out['cost_pct']}%", file=sys.stderr)
    print(f"ring medians (ms): {json.dumps(dm)}; between steps {spans['between_steps_us']:.2f} us; "
          f"host us {json.dumps(spans['host_us'])}", file=sys.stderr)
    for phase in phase_names:
        v = phases[phase]
        print(f"  {phase:34s} {v['kernels']:7.1f} ops, busy {v['busy_ms']:8.4f} ms/step, stamp to stamp "
              f"{v['stamp_to_stamp_ms'] or 0:8.4f}, ring {v.get('ring_ms_in_stretch', '-')}", file=sys.stderr)
        for name, t in v["top"]:
            print(f"      {t:8.4f}  {name}", file=sys.stderr)
    print(f"stretch idle (s) by dxt:: range: {json.dumps(idle)}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
