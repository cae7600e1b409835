#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card at the
cell's own size, several seeds in one process:

    python3 benchmark/control.py --workload <cell> --mode <mode> --seeds <n> [<n> ...]

``program``: the numbers a run compares (training: its first steps, which
need no window; sampling: ``check_calls`` calls).  ``control``: the
reference put in the program's place with the products of the
configuration's bf16 region rounded to fp8 (e4m3), the precision below.
``fault:<name>``: the program with a fault planted underneath
(``faults.py``).  Training's lines also hold readings that no limit
takes: each step's loss gap, and the median leaf's relative difference of
the first gradient (``grad_diff``) and of the change (``delta_diff``) over
all live leaves.  One JSON line a seed; the runs of ``run.py`` never do
any of this."""
import argparse
import contextlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def train_readings(cfg, traffic, fam, seed: int, obs: dict, device) -> dict:
    """The limited numbers of ``obs`` (the program's or the control's first
    steps) against the reference's, and the readings no limit takes."""
    from benchmark.harness import compare, util
    from benchmark.loops import train

    _, ref_batches = fam.train_inputs(cfg, traffic["steps_per_call"], util.rng(seed, util.DATA), device)
    ref = train.reference(cfg, traffic, seed, fam, ref_batches, device)
    masks = compare.live(ref["grad"])
    return dict(compare.train_numbers(obs, ref, fam.READOUT),
                loss_gaps=compare.loss_gaps(obs["losses"], ref["losses"]),
                grad_diff=compare.median_diff(obs["grad"], ref["grad"], masks),
                delta_diff=compare.median_diff(obs["delta"], ref["delta"], masks))


def readings(name: str, mode: str, seed: int, device: str, overrides=None, traffic_overrides=None) -> dict:
    import torch

    from benchmark import faults
    from benchmark.loops import sample, train
    from benchmark.harness import cell, files, util
    from benchmark.reference import lowp

    _, cfg, traffic = cell.load(name, overrides, traffic_overrides)
    fam = files.family(cfg["family"])
    device = torch.device(device)
    if mode == "control" and traffic["kind"] == "train":
        _, ref_batches = fam.train_inputs(cfg, traffic["steps_per_call"], util.rng(seed, util.DATA), device)
        low = train.reference(cfg, traffic, seed, fam, ref_batches, device, q=lowp.FP8)
        return train_readings(cfg, traffic, fam, seed, low, device)
    fault = mode.split(":", 1)[1] if mode.startswith("fault:") else None
    with faults.planted(traffic["kind"], fault) if fault else contextlib.nullcontext():
        if traffic["kind"] == "train":
            b = train.build(cfg, traffic, seed, device, fam)
            obs = train.observe(cfg, traffic, b, train.step_function(cfg, traffic, b))
            del b
            train.free(device)
            return train_readings(cfg, traffic, fam, seed, obs, device)
        b = sample.build(cfg, seed, device, fam)
        with torch.inference_mode():
            calls = {i: sample.call(b, cfg, traffic, util.derive(seed, util.CALL, i))
                     for i in range(traffic["check_calls"])}
    batch = b["batch"]
    del b
    train.free(device)
    return sample.check(cfg, traffic, seed, fam, batch, calls, device,
                        control=mode == "control")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", default="program")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import run

    run.use_caches()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        numbers = readings(args.workload, args.mode, seed, "cuda")
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                          "seconds": time.perf_counter() - t0, **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
