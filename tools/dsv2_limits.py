#!/usr/bin/env python3
"""The readings that ``dsv2lite-aircraft-train``'s limits are set from, on
the card at the cell's own size, several seeds in one process:

    python tools/dsv2_limits.py --mode <mode> --seeds <n> [<n> ...]

``program``, ``control`` and ``fault:<half_batch|unchanged>`` are
``benchmark/control.py``'s modes; ``routing:<top_k_minus_one|renormalised>`` plants
a routing fault in the program's MoE layers
(``benchmark/families/planenet_dsv2.py`` ``routing_fault``) and reads as
``program`` does; ``flips`` counts, in the forward of each seed's first
step (the cell's weights, batch and draw), the tokens whose top-6 choice
of experts differs between the program (bf16 trunk, float32 router) and
the float64 reference, each on its own inputs, per MoE layer, and those
of them whose held experts differ.  Each line also holds the card's peak
memory: ``program_peak_gib`` up to the reference's start (the program's
build and steps), ``reference_peak_gib`` from there on.  One JSON line a
seed.  Needs an NVIDIA GPU."""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "dsv2lite-aircraft-train"


def flips(seed: int, device) -> dict:
    """Per MoE layer: tokens whose top-k set differs between the program
    and the reference, and those whose held experts differ."""
    import torch

    from benchmark.harness import cell, files, util
    from benchmark.harness import weights as wts
    from benchmark.loops import train
    from benchmark.reference import dsv2 as ref_model
    from benchmark.reference import igso3 as ref_igso3
    from benchmark.reference.schedule import Schedule
    from diffusion_extensions_tpu_torch.models.deepseek_v2 import DeepSeekMoE

    _, cfg, traffic = cell.load(CELL)
    fam = files.family(cfg["family"])
    b = train.build(cfg, traffic, seed, device, fam)
    seen = {"program": [], "reference": []}
    orig_route, orig_ref_route = DeepSeekMoE.route, ref_model.route

    def program_route(self, tokens):
        out = orig_route(self, tokens)
        seen["program"].append(out[2].sort(-1).values)
        return out

    def reference_route(p, name, tokens, c):
        out = orig_ref_route(p, name, tokens, c)
        seen["reference"].append(out[2].sort(-1).values)
        return out

    batch = b["pool"][0]
    DeepSeekMoE.route, ref_model.route = program_route, reference_route
    try:
        with torch.no_grad():
            b["loss_fn"](torch.Generator(device=device).manual_seed(util.derive(seed, util.GENERATOR)), batch)
        del b
        train.free(device)
        weights = {k: v.double() for k, v in wts.make(fam.param_spec(cfg), util.derive(seed, util.WEIGHTS),
                                                       device).items()}
        sched = Schedule(cfg["timesteps"], device)
        table = torch.from_numpy(ref_igso3.quantile_table(sched.eps_np)).to(device)
        gen = torch.Generator(device=device).manual_seed(util.derive(seed, util.GENERATOR))
        draw = ref_igso3.draw_step(gen, table, sched.eps, cfg["batch"], fam.SE3)
        with torch.no_grad():
            fam.ref_loss(cfg, sched)(weights, batch.double(), draw)
    finally:
        DeepSeekMoE.route, ref_model.route = orig_route, orig_ref_route
    held = cfg["experts_held"]
    out = []
    for p, r in zip(seen["program"], seen["reference"]):
        differ = (p != r).any(-1)
        mine_p, mine_r = torch.where(p < held, p, -1), torch.where(r < held, r, -1)
        out.append({"tokens": int(p.shape[0]), "topk_differs": int(differ.sum()),
                    "held_differs": int((mine_p.sort(-1).values != mine_r.sort(-1).values).any(-1).sum())})
    return {"layers": out}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mode", default="program")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args()
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import control, run

    run.use_caches()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("dsv2_limits: needs an NVIDIA GPU")
    from benchmark.families import planenet_dsv2
    from benchmark.loops import train

    device = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    orig_reference = train.reference
    ref_peak = {}

    def reference(*a, **k):  # the reference's own peak
        torch.cuda.synchronize()
        ref_peak["program_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        out = orig_reference(*a, **k)
        torch.cuda.synchronize()
        ref_peak["gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        return out

    train.reference = reference
    for seed in args.seeds:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if args.mode == "flips":
            numbers = flips(seed, device)
        else:
            mode, fault = args.mode, None
            if mode.startswith("routing:"):
                mode, fault = "program", mode.split(":", 1)[1]
            with planenet_dsv2.routing_fault(fault) if fault else contextlib.nullcontext():
                numbers = control.readings(CELL, mode, seed, "cuda")
        numbers["program_peak_gib"] = ref_peak.pop("program_gib", None)
        numbers["reference_peak_gib"] = ref_peak.pop("gib", None)
        numbers["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        print(json.dumps({"workload": CELL, "mode": args.mode, "seed": seed, "card": card,
                          "seconds": time.perf_counter() - t0, **numbers}), flush=True)
        train.free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
