"""Grid sweep over the port's experiment drivers (counterpart of the JAX
package's ``tools/sweep.py``, the offline stand-in for the reference's
wandb sweep, ``slurm-scripts/sweep.yaml``).

Runs every combination of a JSON parameter grid through
``python -m diffusion_extensions_tpu_torch.experiments.<module>`` in turn,
each with its own ``--ckpt`` and ``--log`` under ``--out`` and the extra
flags after ``--``, collects the chosen metric from each run's JSONL log,
ranks the runs (a run that exited non-zero sinks to the bottom) and writes
the ranked ``summary.json`` to ``--out``:

    python -m diffusion_extensions_tpu_torch.sweep lock --steps 2000 \\
        --grid '{"lr": [1e-4, 3e-4]}' --metric loss -- --param so3

The drivers run on the card; ``-- --device cpu`` passes ``--device`` to
every run with the other extra flags.  ``--out`` defaults to
``torch_results/sweeps/run``, never the committed ``sweeps/`` of the JAX
package's runs.
"""
from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

__all__ = ["collect_metric", "rank_results", "main"]


def collect_metric(log_path: str, metric: str, agg: str = "last"):
    """Aggregate ``metric`` over a run's JSONL log.  ``agg``: "last",
    "min", "max", or "mean10" (mean of the last 10 logged values).
    Returns None when the log or metric is absent."""
    if not os.path.exists(log_path):
        return None
    vals = []
    with open(log_path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            v = rec.get(metric)
            if v is not None and not (isinstance(v, float) and math.isnan(v)):
                vals.append(float(v))
    if not vals:
        return None
    if agg == "last":
        return vals[-1]
    if agg == "min":
        return min(vals)
    if agg == "max":
        return max(vals)
    if agg == "mean10":
        tail = vals[-10:]
        return sum(tail) / len(tail)
    raise ValueError(f"unknown agg: {agg}")


def rank_results(results, maximize: bool = False):
    """Sort result records by their ``value`` and attach 1-based ``rank``.
    A run that exited non-zero sinks to the bottom even if its partial log
    holds metric values: a crashed configuration never outranks a
    completed one."""
    def ok(r):
        return r.get("value") is not None and not r.get("returncode")

    scored = [r for r in results if ok(r)]
    failed = [r for r in results if not ok(r)]
    scored.sort(key=lambda r: r["value"], reverse=maximize)
    ranked = scored + failed
    for i, r in enumerate(ranked):
        r["rank"] = i + 1
    return ranked


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Grid sweep over an experiment driver of the port")
    p.add_argument("module", help="experiment module name (e.g. lock)")
    p.add_argument("--grid", required=True, help="JSON dict of param lists")
    p.add_argument("--out", default=os.path.join("torch_results", "sweeps", "run"))
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--metric", default="loss",
                   help="metric key to collect from each run's JSONL log "
                        "(wandb-sweep 'test loss' equivalent)")
    p.add_argument("--agg", default="mean10", choices=("last", "min", "max", "mean10"),
                   help="aggregation over the logged metric values")
    p.add_argument("--maximize", action="store_true",
                   help="rank high-is-better (default: minimize)")
    p.add_argument("rest", nargs="*", help="extra flags passed to every run (after --)")
    # the flags after "--" are split off here: argparse before Python 3.12.7
    # gives them to no positional once ``module`` has been read
    argv = list(sys.argv[1:] if argv is None else argv)
    extra = []
    if "--" in argv:
        cut = argv.index("--")
        argv, extra = argv[:cut], argv[cut + 1:]
    args = p.parse_args(argv)
    args.rest += extra
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    grid = json.loads(args.grid)
    keys = sorted(grid)
    combos = list(itertools.product(*(grid[k] for k in keys)))
    print(f"{len(combos)} runs over {keys}; "
          f"{'maximizing' if args.maximize else 'minimizing'} {args.agg}({args.metric})")
    results = []
    for combo in combos:
        tag = "_".join(f"{k}{v}" for k, v in zip(keys, combo))
        run_dir = os.path.join(args.out, tag)
        os.makedirs(run_dir, exist_ok=True)
        cmd = [sys.executable, "-u", "-m",
               f"diffusion_extensions_tpu_torch.experiments.{args.module}"]
        for k, v in zip(keys, combo):
            cmd += [f"--{k}", str(v)]
        if args.steps is not None:
            cmd += ["--steps", str(args.steps)]
        log_path = os.path.abspath(os.path.join(run_dir, "metrics.jsonl"))
        cmd += ["--ckpt", os.path.abspath(os.path.join(run_dir, "ckpt")), "--log", log_path]
        cmd += args.rest
        print(">>", " ".join(cmd), flush=True)
        proc = subprocess.run(cmd, cwd=REPO)
        value = collect_metric(log_path, args.metric, args.agg)
        results.append({"params": dict(zip(keys, combo)), "tag": tag,
                        "returncode": proc.returncode, "value": value})
        print(json.dumps(results[-1]), flush=True)

    ranked = rank_results(results, maximize=args.maximize)
    summary = {"module": args.module, "metric": args.metric, "agg": args.agg,
               "maximize": args.maximize, "ranked": ranked}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(f"\nranked by {args.agg}({args.metric}) ({'max' if args.maximize else 'min'} first):")
    width = max((len(r["tag"]) for r in ranked), default=4)
    for r in ranked:
        val = "FAILED" if r["value"] is None else f"{r['value']:.6g}"
        print(f"  #{r['rank']:<3} {r['tag']:<{width}}  {val}")
    print(f"summary -> {os.path.join(args.out, 'summary.json')}")
    return summary


if __name__ == "__main__":
    main()
