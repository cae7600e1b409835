"""The system's headline measurement on the card (counterpart of the JAX
package's ``bench.py``; run as ``python bench_torch.py [--quick] ...``).

Headline: aircraft train steps/s/chip at ``bench.py``'s configuration
(PlaneNet d512 / 4 heads / 4 layers, batch 32 x 256 points,
``ProjectedSO3Diffusion`` T = 1000, plain Adam at lr 1e-4, bf16 autocast,
8 steps a call: one step captured in a CUDA graph and replayed,
``parallel/dp.py``).  Prints ONE JSON line with ``bench.py``'s keys
(``metric``, ``value``, ``unit``, ``vs_baseline``, ``mfu``,
``gflops_per_step``, ``rows``, ``mfu_approx`` with ``--no-bf16``,
``quick`` with ``--quick``, and the regression fields) plus ``peak`` (the
peak FLOP rate ``mfu`` divides by, by name) and ``device`` (the card's
name).  ``rows`` holds ``bench.py``'s eleven rows at its configurations:

  protein_train_b4 / _b16 / _b32   ProtNet d1024 / 8 heads / t_depth 12 /
                                   c_depth 8 (SE(3), bf16 autocast), plain
                                   Adam, one eager step a call
  protein_train_b4_opt             the same at batch 4 with fused Adam,
                                   bf16 moments and 8 replayed steps a call
  moe_train_e4                     the headline step with a 4-expert Switch
                                   MoE feed-forward (scatter dispatch)
  bingham_train                    RotPredict d65 / SO3Diffusion, batch 64 of
                                   identity rotations, 16 replayed steps a call
  mmd_eval                         MMD of two sets of 20,000 Haar rotations
                                   (8,000 with --quick) with the Gaussian
                                   rotation kernel: three launches of the
                                   CUDA kernel ``gaussian_kernel_sum`` a call
  sampler_1000 / ddim_50 /         RotPredict d65 over 512 chains: the
  pf_flow_50 / ddim_50_picard      1000-step ancestral chain, DDIM-50, the
                                   quantile-transport probability flow (50
                                   evaluations) and Picard DDIM-50 with its
                                   sweep count

Timing: ``_time_calls`` runs the warm-up calls (where a K-step call
captures its graph), synchronises, then times ``n_calls`` calls up to a
final ``torch.cuda.synchronize()``.

FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over one eager step
(K = 1) of each row, after the timed calls (a replayed graph shows the
counter nothing, and an eager backward before the capture would leave
the MoE layers' load-balance loss holding an autograd graph of the
default stream, which the captured backward may not join).  It counts the matrix products of the forward and the
backward (mm, addmm, bmm, baddbmm, convolution, attention) and leaves out
Adam and every elementwise operation, so it is below XLA's count of the
JAX step (``bench._flops_per_step``, which counts everything:
``tools/xla_bench_flops.py``).  The MoE row's count covers the padded
E x C expert slots (10,240 against 8,192 tokens a layer), as XLA's
einsum count does.  ``diffusion_extensions_tpu_torch/flops.py`` is the
forward's closed form.

Peak: the NVIDIA H100 SXM5 data sheet's dense bf16 989.4 TFLOP/s with
``--bf16`` (the default), its fp32 66.9 TFLOP/s with ``--no-bf16`` (the
package turns TF32 off, so float32 products run on the CUDA cores;
``mfu_approx`` marks the mode as ``bench.py`` does).  ``mfu`` = steps/s
x FLOPs a step / peak, on a CUDA device only (``None`` elsewhere).

``vs_baseline`` divides by ``bench.py``'s REF_GPU_STEPS_PER_SEC = 19.3:
the reference's speed-of-light bound on its own GPUs (13.4 float32
TFLOP/s / 693.6 GFLOP a step, ``BASELINE.md``), not a TPU figure.

Numbers are printed unrounded.  Regression check: the headline and each row against the newest
``BENCH_TORCH_r*.json`` at the repository root (this port's records
only), printed to stderr; none there gives no fields.

Runs on the card unless ``--device`` says otherwise; on a machine without
a GPU it raises.
"""
from __future__ import annotations

import argparse
import gc
import glob
import json
import os
import re
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from . import resolve_device
from .data.pdb import pad_prot_batch, synthetic_prot_pair, to_device
from .data.shapenet import synthetic_planes
from .experiments import aircraft, protein
from .models.planenet import PlaneNet
from .models.protnet import ProtNet
from .models.rot_predict import RotPredict
from .ops.metrics import gaussian_kernel_matrix, mmd
from .ops.so3 import haar_rotations
from .parallel.dp import make_dp_train_step
from .processes.se3 import ProjectedSE3Diffusion
from .processes.so3 import ProjectedSO3Diffusion, SO3Diffusion
from .train.optim import make_optimizer
from .train.state import TrainState

__all__ = ["main", "bench_aircraft", "bench_protein", "bench_bingham", "bench_mmd",
           "bench_samplers", "step_flops"]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference's speed-of-light bound on its own GPUs (bench.py, BASELINE.md)
REF_GPU_STEPS_PER_SEC = 19.3
# NVIDIA H100 SXM5 data sheet, dense
PEAK_BF16 = 989.4e12
PEAK_F32 = 66.9e12
PEAK_NAMES = {PEAK_BF16: "H100 SXM5 dense bf16 989.4 TFLOP/s",
              PEAK_F32: "H100 SXM5 fp32 66.9 TFLOP/s (no TF32)"}
# the rows' configurations (bench.py's)
PROTEIN_NET = dict(dim=1024, heads=8, t_depth=12, c_depth=8)
TIMESTEPS = 1000
SAMPLER_CHAINS = 512
MMD_N = 20_000
MMD_N_QUICK = 8_000


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _free(out, device: torch.device):
    """``out``, once a finished row's model, optimizer and graphs are
    returned to the card, so that the next row's peak is its own."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def peak_flops(device: torch.device, bf16: bool):
    """(peak FLOP/s that ``mfu`` divides by, its name); (None, None) off the card."""
    if device.type != "cuda":
        return None, None
    peak = PEAK_BF16 if bf16 else PEAK_F32
    return peak, PEAK_NAMES[peak]


def _mfu(steps_per_sec: float, flops: float, peak) -> float | None:
    return None if peak is None else steps_per_sec * flops / peak


def step_flops(step_fn, state: TrainState, batch) -> float:
    """The FLOPs FlopCounterMode counts in one eager call of ``step_fn``
    (a K = 1 step: the call is a train step on ``state``)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        step_fn(state, batch)
    return float(counter.get_total_flops())


def _previous_bench(root: str = ROOT):
    """The newest ``BENCH_TORCH_r*.json`` under ``root`` with its round
    number as ``_round``, or None.  A record wrapped as {"tail": "...<the
    JSON line>"} is unwrapped to the line."""
    best = None
    for path in glob.glob(os.path.join(root, "BENCH_TORCH_r*.json")):
        m = re.search(r"BENCH_TORCH_r(\d+)\.json$", path)
        if m and (best is None or int(m.group(1)) > best[0]):
            best = (int(m.group(1)), path)
    if best is None:
        return None
    try:
        with open(best[1]) as f:
            prev = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if "value" not in prev and "tail" in prev:
        for line in reversed(str(prev["tail"]).splitlines()):
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                inner = json.loads(line)
            except json.JSONDecodeError:
                continue
            if "value" in inner:
                prev = inner
                break
        else:
            return None
    prev["_round"] = best[0]
    return prev


def _regression_check(result: dict, threshold_pct: float = 3.0, root: str = ROOT) -> dict:
    """The headline and each row against the previous record (stderr); the
    fields to merge into the result, none without a record.  A row
    regresses when its steps/s drop or its seconds rise by more than 10%."""
    prev = _previous_bench(root)
    if prev is None or not prev.get("value"):
        return {}
    delta_pct = 100.0 * (result["value"] - prev["value"]) / prev["value"]
    flag = delta_pct < -threshold_pct
    print(f"[bench] headline vs BENCH_TORCH_r{prev['_round']:02d}: "
          f"{prev['value']:.2f} -> {result['value']:.2f} steps/s/chip ({delta_pct:+.2f}%)"
          + (f"  ** REGRESSION > {threshold_pct}% **" if flag else ""), file=sys.stderr)
    row_regressions = {}
    for name, row in (result.get("rows") or {}).items():
        prow = (prev.get("rows") or {}).get(name)
        if not isinstance(prow, dict) or not isinstance(row, dict):
            continue
        for k in ("steps_per_sec", "seconds"):
            if k in row and k in prow and prow[k]:
                d = 100.0 * (row[k] - prow[k]) / prow[k]
                worse = d < -10.0 if k == "steps_per_sec" else d > 10.0
                if worse:
                    row_regressions[f"{name}.{k}"] = round(d, 1)
                print(f"[bench]   {name}.{k}: {prow[k]} -> {row[k]} ({d:+.1f}%)"
                      + ("  ** ROW REGRESSION > 10% **" if worse else ""), file=sys.stderr)
    return {"prev_round": prev["_round"], "prev_value": prev["value"],
            "delta_pct": round(delta_pct, 2), "regression": flag,
            "row_regressions": row_regressions}


def _time_calls(fn, args_fn, n_calls: int, warmup: int, device: torch.device) -> float:
    """Seconds of ``n_calls`` calls after ``warmup`` calls, each phase
    ended by a synchronise."""
    for _ in range(warmup):
        fn(*args_fn())
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(n_calls):
        fn(*args_fn())
    _sync(device)
    return time.perf_counter() - t0


def bench_aircraft(args, n_chips: int, moe_experts: int = 0):
    """(steps/s/chip, mfu, FLOPs a step) of the aircraft train step."""
    device = resolve_device(args.device)
    torch.manual_seed(0)
    model = PlaneNet(dim=args.dim, heads=args.heads, layers=args.layers, bf16=args.bf16,
                     moe_experts=moe_experts, moe_dispatch="scatter").to(device)
    process = ProjectedSO3Diffusion(timesteps=TIMESTEPS, device=device)
    if args.headline_opt:
        opt = make_optimizer(model.named_parameters(), 1e-4, impl="fused", state_dtype="bf16")
    else:
        opt = make_optimizer(model.named_parameters(), 1e-4)
    state = TrainState(model, opt, torch.Generator(device=device).manual_seed(0))
    loss_fn = aircraft.make_loss_fn(model, process, so3=True)
    K = max(args.steps_per_call, 1)
    step_fn = make_dp_train_step(loss_fn, model, opt, steps_per_call=K)

    data = synthetic_planes(256, points=args.samples, seed=0)
    rng = np.random.default_rng(0)

    def mk_batch():
        b = torch.from_numpy(data[rng.integers(0, len(data), K * args.batch)]).to(device)
        return b.reshape(K, args.batch, args.samples, 3) if K > 1 else b

    batches = [mk_batch() for _ in range(8)]
    n_calls = max(args.steps // K, 1)
    warm_calls = max(args.warmup // K, 3)
    i = {"n": 0}

    def next_args():
        i["n"] += 1
        return (batches[i["n"] % len(batches)],)

    dt = _time_calls(lambda b: step_fn(state, b), next_args, n_calls, warm_calls, device)
    steps_per_sec = n_calls * K / dt
    per_chip = steps_per_sec / n_chips
    one = batches[0][0] if K > 1 else batches[0]
    flops = step_flops(make_dp_train_step(loss_fn, model, opt), state, one)
    peak, _ = peak_flops(device, args.bf16)
    return per_chip, _mfu(per_chip, flops, peak), flops


def bench_protein(batch: int, quick: bool, opt: bool = False, device=None):
    """(steps/s, mfu, FLOPs a step) of the ProtNet SE(3) train step at
    ``batch``: plain Adam at K = 1, or (``opt``) fused Adam with bf16
    moments at K = 8 over the same batch repeated."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    pairs = [synthetic_prot_pair(rng) for _ in range(16)]
    lr, ll = protein.bucket_lengths(pairs)
    pb_np = pad_prot_batch([pairs[i % len(pairs)] for i in range(batch)], lr, ll)
    torch.manual_seed(0)
    with torch.device(device):
        model = ProtNet(**PROTEIN_NET, se3=True, bf16=True)
    process = ProjectedSE3Diffusion(timesteps=TIMESTEPS, device=device)
    if opt:
        optimizer = make_optimizer(model.named_parameters(), 1e-4, impl="fused",
                                   state_dtype="bf16")
    else:
        optimizer = make_optimizer(model.named_parameters(), 1e-4)
    state = TrainState(model, optimizer, torch.Generator(device=device).manual_seed(0))
    loss_fn = protein.make_loss_fn(model, process, se3=True)
    K = 8 if opt else 1
    step_fn = make_dp_train_step(loss_fn, model, optimizer, steps_per_call=K)
    # on the card before the timed calls: they time the step, not a copy
    one = to_device(pb_np, device)
    pb = to_device(protein.stack_batches([pb_np] * K), device) if K > 1 else one

    n_calls, warmup = (20, 3) if quick else (60, 8)
    dt = _time_calls(lambda b: step_fn(state, b), lambda: (pb,), n_calls, warmup, device)
    sps = n_calls * K / dt
    flops = step_flops(make_dp_train_step(loss_fn, model, optimizer), state, one)
    peak, _ = peak_flops(device, True)
    return sps, _mfu(sps, flops, peak), flops


def bench_bingham(quick: bool, device=None) -> float:
    """Steps/s of the Bingham train step, 16 replayed steps a call."""
    device = resolve_device(device)
    torch.manual_seed(0)
    model = RotPredict(d_model=65, out_type="skewvec").to(device)
    process = SO3Diffusion.create(TIMESTEPS, loss_type="skewvec", device=device)
    opt = make_optimizer(model.named_parameters(), 1e-4)
    state = TrainState(model, opt, torch.Generator(device=device).manual_seed(0))
    K = 16
    step_fn = make_dp_train_step(lambda gen, x: process.loss(model, gen, x), model, opt,
                                 steps_per_call=K)
    x_start = torch.eye(3, device=device).repeat(K, 64, 1, 1)
    n_calls, warmup = (10, 2) if quick else (30, 4)
    dt = _time_calls(lambda x: step_fn(state, x), lambda: (x_start,), n_calls, warmup, device)
    return n_calls * K / dt


def bench_mmd(quick: bool, device=None):
    """(n, seconds a call) of MMD(n Haar rotations, n others), Gaussian
    kernel, chunks of 4000: one warm-up call and three timed ones."""
    device = resolve_device(device)
    n = MMD_N_QUICK if quick else MMD_N
    a = haar_rotations(torch.Generator(device=device).manual_seed(1), (n,))
    b = haar_rotations(torch.Generator(device=device).manual_seed(2), (n,))

    def f(a, b):
        return mmd(a, b, gaussian_kernel_matrix, chunksize=4000)

    dt = _time_calls(f, lambda: (a, b), 3, 1, device)
    return n, dt / 3


@torch.inference_mode()
def bench_samplers(quick: bool, device=None):
    """(chains, seconds a chain call for ancestral-1000, DDIM-50, PF
    flow-50 and Picard DDIM-50, Picard's sweeps) of RotPredict d65."""
    device = resolve_device(device)
    torch.manual_seed(0)
    model = RotPredict(d_model=65, out_type="skewvec").to(device)
    process = SO3Diffusion.create(TIMESTEPS, device=device)
    n = SAMPLER_CHAINS

    def gen(seed: int):
        return (torch.Generator(device=device).manual_seed(seed),)

    def anc(g):
        return process.p_sample_loop(model, g, (n,))

    def ddim(g):
        return process.ddim_sample_loop(model, g, (n,), num_steps=50)

    def flow(g):
        return process.pf_sample_loop(model, g, (n,), num_steps=50)

    def picard(g):
        return process.parallel_sample_loop(model, g, (n,), num_steps=50, tol=1e-4,
                                            return_sweeps=True)

    reps = 2 if quick else 4
    dt_anc = _time_calls(anc, lambda: gen(3), reps, 1, device)
    dt_ddim = _time_calls(ddim, lambda: gen(4), reps, 1, device)
    dt_flow = _time_calls(flow, lambda: gen(5), reps, 1, device)
    # the warm-up call gives the sweep count, read outside the timed window
    _, sweeps = picard(*gen(6))
    _sync(device)
    dt_pic = _time_calls(picard, lambda: gen(6), reps, 0, device)
    return n, dt_anc / reps, dt_ddim / reps, dt_flow / reps, dt_pic / reps, int(sweeps)


def _train_row(sps: float, mfu, flops: float) -> dict:
    return {"steps_per_sec": sps, "mfu": mfu, "gflops_per_step": flops / 1e9}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Headline measurement of the port on the card")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--warmup", type=int, default=20)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--samples", type=int, default=256)
    p.add_argument("--dim", type=int, default=512)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--no-bf16", dest="bf16", action="store_false")
    p.add_argument("--steps-per-call", dest="steps_per_call", type=int, default=8,
                   help="optimizer steps per call (one CUDA graph replayed a step)")
    p.add_argument("--quick", action="store_true", help="short measurement")
    p.add_argument("--headline-only", dest="headline_only", action="store_true",
                   help="skip the secondary rows")
    p.add_argument("--headline-opt", dest="headline_opt", action="store_true",
                   help="run the headline with fused Adam and bf16 moments (A/B probe; "
                        "the recorded headline stays plain Adam)")
    p.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    args = p.parse_args(argv)
    if args.quick:
        # enough calls that K-step calls are measured steady-state
        args.steps, args.warmup = 80, 24
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench: no CUDA device (torch.cuda.is_available() is false); "
                           "pass --device cpu to run the rows on the CPU")
    peak, peak_name = peak_flops(device, args.bf16)
    per_chip, mfu, flops = _free(bench_aircraft(args, _world()), device)

    rows = {}
    if not args.headline_only:
        for b in (4, 16, 32):
            rows[f"protein_train_b{b}"] = _train_row(
                *_free(bench_protein(b, args.quick, device=device), device))
        rows["protein_train_b4_opt"] = _train_row(
            *_free(bench_protein(4, args.quick, opt=True, device=device), device))
        rows["moe_train_e4"] = _train_row(
            *_free(bench_aircraft(args, _world(), moe_experts=4), device))
        sps = _free(bench_bingham(args.quick, device), device)
        rows["bingham_train"] = {"steps_per_sec": sps}
        n_mmd, mmd_s = bench_mmd(args.quick, device)
        rows["mmd_eval"] = {"n_samples": n_mmd, "seconds": mmd_s}
        n_s, anc_s, ddim_s, flow_s, pic_s, sweeps = _free(bench_samplers(args.quick, device),
                                                          device)
        rows["sampler_1000"] = {"chains": n_s, "seconds": anc_s}
        rows["ddim_50"] = {"chains": n_s, "seconds": ddim_s}
        rows["pf_flow_50"] = {"chains": n_s, "seconds": flow_s}
        rows["ddim_50_picard"] = {"chains": n_s, "seconds": pic_s, "sweeps": sweeps}

    result = {
        "metric": "aircraft_rotate train steps/sec/chip "
        "(PlaneNet d512 h4 l4, batch 32, 256 pts, ProjectedSO3Diffusion)",
        "value": per_chip,
        "unit": "steps/sec/chip",
        "vs_baseline": per_chip / REF_GPU_STEPS_PER_SEC,
        "mfu": mfu,
        "gflops_per_step": flops / 1e9,
        "rows": rows,
        "peak": peak_name,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else str(device),
    }
    if not args.bf16:
        result["mfu_approx"] = True
    if args.quick:
        # a short run: never a calibrated record
        result["quick"] = True
    result.update(_regression_check(result))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
