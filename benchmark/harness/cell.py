"""One run of one cell: the loop of its traffic's kind, then the result
line's metrics, device and checks."""
from __future__ import annotations

import subprocess

import torch

from . import compare, files


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them (a card
    set under 700 W runs slower under load)."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def load(name: str, overrides=None, traffic_overrides=None):
    """(cell, configuration, traffic) of a cell; ``overrides`` and
    ``traffic_overrides`` replace keys (the tests' small sizes)."""
    cell = files.workload(name)
    cfg = dict(files.config(cell["config"]), **(overrides or {}))
    traffic = dict(files.traffic(cell["traffic"]), **(traffic_overrides or {}))
    return cell, cfg, traffic


def run(name: str, seed: int, seconds: float, trace: bool, device, t0: float, overrides=None,
        traffic_overrides=None) -> dict:
    """The result of one run (the line's keys) and the numbers read for
    the checks."""
    bench = files.benchmark()
    cell, cfg, traffic = load(name, overrides, traffic_overrides)
    fam = files.family(cfg["family"])
    device = torch.device(device)
    out = files.loop(traffic["kind"]).run(cfg, traffic, seed, seconds, trace, device, t0, fam)
    numbers, limits = out["numbers"], cell["limits"]
    correct = compare.judge(numbers, limits) and out["failed"] == 0
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"]}
    if trace:
        ctx = out["trace"]
        metrics = {}
        for m in files.cell_metrics(bench, name, "per_layer"):
            value = files.metric(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=ctx["busy_s"], window_s=ctx["window_s"])
        result.update(metrics=metrics, device=dev,
                      breakdown={"device_ops": [list(x) for x in ctx["device_ops"]],
                                 "idle_gaps": [list(x) for x in ctx["idle_gaps"]]})
    else:
        metrics = {}
        for m in files.cell_metrics(bench, name, "end_to_end"):
            metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}
        result.update(metrics=metrics, device=dev)
    result["checks"] = compare.report(numbers, limits)
    return {"result": result, "setup_phases": out["setup_phases"]}
