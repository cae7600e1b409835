"""Training traffic: closed loop, one caller, calls of K optimizer steps
(``make_dp_train_step``: on the card one step captured in a CUDA graph
and replayed K times) over a pool of K distinct batches on the device.

Set-up builds one train state from the seed and drives it through its
first ``check_steps`` steps, one call of one step each through the same
step function and feed as the window (the first is the eager step before
the capture, the others replays).  The program's losses, its first
gradient (from Adam's first moment after one step, mu / (1 - b1)) and the
weights' change are copied to the host there; the reference repeats
those steps after the window from the same weights, batches and seed.
"""
from __future__ import annotations

import gc
import time

import torch

from ..flops import STEP_FORWARDS
from ..harness import compare, util
from ..harness import weights as wts
from ..harness.trace import Stretch
from ..reference import igso3 as ref_igso3
from ..reference.schedule import Schedule
from ..reference.train import first_steps


def _host(tensors) -> list:
    return [t.detach().float().cpu() for t in tensors]


def build(cfg: dict, traffic: dict, seed: int, device: torch.device, fam, clock=None) -> dict:
    """The train state, its optimizer and the pool, from the seed;
    ``clock`` (``util.Clock``) times the phases."""
    from diffusion_extensions_tpu_torch.train.optim import make_optimizer
    from diffusion_extensions_tpu_torch.train.state import TrainState

    clock = clock or util.Clock()
    clock.mark("imports")
    torch.empty(0, device=device)
    clock.mark("device_context")
    w0 = wts.make(fam.param_spec(cfg), util.derive(seed, util.WEIGHTS), device)
    util.sync(device)
    clock.mark("weights")
    model = fam.build_model(cfg, w0, device)
    clock.mark("model")
    process, loss_fn = fam.build_train(cfg, model, device)
    clock.mark("process_tables")
    opt = make_optimizer(model.named_parameters(), cfg["lr"], impl=cfg["opt_impl"],
                         state_dtype=cfg["opt_state_dtype"])
    state = TrainState(model, opt, torch.Generator(device=device).manual_seed(util.derive(seed, util.GENERATOR)))
    pool, ref_batches = fam.train_inputs(cfg, traffic["steps_per_call"], util.rng(seed, util.DATA), device)
    clock.mark("optimizer_inputs")
    return {"w0": w0, "model": model, "process": process, "loss_fn": loss_fn, "opt": opt, "state": state,
            "pool": pool, "ref_batches": ref_batches, "names": [n for n, _ in model.named_parameters()]}


def step_function(cfg: dict, traffic: dict, b: dict):
    from diffusion_extensions_tpu_torch.parallel.dp import make_dp_train_step

    return make_dp_train_step(b["loss_fn"], b["model"], b["opt"], steps_per_call=traffic["steps_per_call"],
                              log_norms=cfg["log_norms"])


def observe(cfg: dict, traffic: dict, b: dict, step_fn) -> dict:
    """The first ``check_steps`` steps of ``b``'s state, one call each:
    the losses, the first gradient and the weights' change, on the host.
    The initial weights are dropped from ``b`` after."""
    state, losses, grad = b["state"], [], None
    for i in range(traffic["check_steps"]):
        state, metrics = step_fn(state, util.tree_map(lambda x: x[i:i + 1], b["pool"]))
        losses.append(metrics["loss"])
        if i == 0:
            grad = _host(m.float() / (1 - b["opt"].b1) for m in b["opt"].mu)
    params = dict(state.model.named_parameters())
    w0 = b.pop("w0")
    delta = _host(params[n].detach() - w0[n] for n in b["names"])
    return {"losses": [float(x) for x in losses], "grad": dict(zip(b["names"], grad)),
            "delta": dict(zip(b["names"], delta))}


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device: torch.device, t0: float, fam) -> dict:
    k = traffic["steps_per_call"]
    clock = util.Clock(t0)
    b = build(cfg, traffic, seed, device, fam, clock)
    step_fn = step_function(cfg, traffic, b)
    obs = observe(cfg, traffic, b, step_fn)
    util.sync(device)
    clock.mark("checked_steps_capture")
    state, pool = b["state"], b["pool"]
    step_fn(state, pool)  # a whole call: every shape the window uses
    util.sync(device)
    clock.mark("warm_call")

    marks, losses, calls = util.Marks(device), [], 0
    stretch = None
    t_start = time.perf_counter()
    marks.mark()
    while True:
        if trace and calls == traffic["trace_after_calls"]:
            stretch = Stretch().__enter__()
        state, metrics = step_fn(state, pool)
        marks.mark()
        losses.append(metrics["loss"])
        calls += 1
        if stretch is not None and calls == traffic["trace_after_calls"] + traffic["trace_calls"]:
            stretch.__exit__(None, None, None)
        marks.wait(calls - 1)  # the host leads the device by at most one call
        traced = not trace or calls > traffic["trace_after_calls"] + traffic["trace_calls"]
        if time.perf_counter() - t_start >= seconds and traced:
            break
    util.sync(device)
    t_end = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    ref_batches = b["ref_batches"]
    del b, state, step_fn, pool, metrics, losses
    free(device)
    numbers = check(cfg, traffic, seed, fam, ref_batches, obs, device)

    out = {"attempted": calls, "failed": failed, "memory_peak_bytes": peak, "numbers": numbers,
           "setup_phases": clock.phases,
           "e2e": {"setup_s": t_start - t0,
                   "train_step_ms": (t_end - t_start) * 1e3 / (calls * k),
                   "peak_mem_gib": peak / 2 ** 30}}
    if stretch is not None:
        s = stretch.summary()
        traced = traffic["trace_calls"] * k
        out["trace"] = dict(s, steps=traced, flops_step=STEP_FORWARDS * fam.forward_flops(cfg),
                            wall_per_step_s=(t_end - t_start - s["held_s"]) / (calls * k - traced))
    return out


def reference(cfg, traffic, seed, fam, ref_batches, device, q=None) -> dict:
    """The reference's first steps from the cell's weights, batches and
    randomness; ``q`` rounds the products of the autocast region (the
    control)."""
    weights = wts.make(fam.param_spec(cfg), util.derive(seed, util.WEIGHTS), device)
    sched = Schedule(cfg["timesteps"], device)
    table = torch.from_numpy(ref_igso3.quantile_table(sched.eps_np)).to(device)
    gen = torch.Generator(device=device).manual_seed(util.derive(seed, util.GENERATOR))
    batch = cfg["batch"]

    def draw():
        return ref_igso3.draw_step(gen, table, sched.eps, batch, fam.SE3)

    return first_steps(fam.ref_loss(cfg, sched, q), weights, ref_batches[:traffic["check_steps"]], draw,
                       cfg["lr"])


def check(cfg, traffic, seed, fam, ref_batches, obs, device) -> dict:
    """The program's first steps (``obs``) against the reference's."""
    return compare.train_numbers(obs, reference(cfg, traffic, seed, fam, ref_batches, device), fam.READOUT)
