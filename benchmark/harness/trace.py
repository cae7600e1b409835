"""The traced stretch of a window: ``torch.profiler`` over a few calls,
reduced to what the per-layer readers take.

Busy time is the union of the device's operation intervals (kernels,
copies, fills): overlapping kernels count once, where a sum of durations
would count them twice.  Idle gaps are the stretch's time outside that
union, each named by the innermost host operation running at its middle."""
from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

TOP = 10
_COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")


def union(intervals: list) -> list:
    """Merge (start, end) intervals into disjoint sorted ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def busy(intervals: list) -> float:
    return sum(e - s for s, e in union(intervals))


def _events(prof):
    """(device events, host events) as (name, start_ns, end_ns)."""
    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        row = (ev.name(), s, s + ev.duration_ns())
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append(row)
        else:
            host.append(row)
    return dev, host


def _name_gaps(gaps: list, host: list, reach: int = 5000) -> list:
    """[name, seconds] for each gap: the shortest of the ``reach`` host
    events that start last before its middle and cover it, or "no host
    op"."""
    host = sorted(host, key=lambda r: r[1])
    starts = [r[1] for r in host]
    named = []
    for s, e in gaps:
        mid, best = (s + e) / 2, None
        i = bisect.bisect_right(starts, mid)
        for name, hs, he in host[max(0, i - reach):i][::-1]:
            if he >= mid and (best is None or he - hs < best[1]):
                best = (name, he - hs)
        named.append([best[0] if best else "no host op", (e - s) / 1e9])
    return named


class Stretch:
    """``with Stretch() as st: <calls>`` profiles the calls; afterwards
    ``st.summary()`` holds busy_s, window_s, kernels and the breakdown.
    The stretch starts and ends with a synchronise, so that its wall time
    holds all of its device work."""

    def __enter__(self):
        self.started = time.perf_counter()  # the profiler's own start and stop count outside the window
        torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                       torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        self.held_s = time.perf_counter() - self.started
        return False

    def summary(self) -> dict:
        dev, host = _events(self.prof)
        intervals = [(s, e) for _, s, e in dev]
        merged = union(intervals)
        by_name = defaultdict(float)
        for name, s, e in dev:
            by_name[name] += (e - s) / 1e9
        gaps = [(a[1], b[0]) for a, b in zip(merged, merged[1:])]
        gaps.sort(key=lambda g: g[0] - g[1])
        gap_by_name = defaultdict(float)
        for name, sec in _name_gaps(gaps[:50], host):
            gap_by_name[name] += sec
        kernels = sum(1 for name, _, _ in dev if not name.startswith(_COPY_PREFIXES))
        return {
            "busy_s": busy(intervals) / 1e9,
            "window_s": self.window_s,
            "held_s": self.held_s,
            "kernels": kernels,
            "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP],
            "idle_gaps": sorted(gap_by_name.items(), key=lambda kv: -kv[1])[:TOP],
        }
