"""Sampling traffic: closed loop, one caller; each call one SE(3) DDIM
chain (``processes/se3.py`` ``ddim_sample_loop``) over the poses of one
batch with the experiment's projection, from noise drawn from the seed and
the call's index, ending with the sample on the host (as the protein
experiment's ``--test`` does).

The window's calls keep, by reference and without a copy, the state each
projection was asked for and each output of the denoiser.  After the
window the reference checks a sample of the calls, drawn from the seed
(always the last): the start against its own draw, then at every step
from the program's state the denoiser (the reference's forward against the
program's output) and the step (the reference's DDIM step from the
program's state and output against the program's next state, and the
final x_0 estimate against the answer).  The chain is followed step by
step because a step at t = 999 multiplies rounding in the denoiser's
output by sqrt(1 / acp - 1) = 2e4: two free chains part at once.
"""
from __future__ import annotations

import gc
import time

import torch

from ..harness import util
from ..harness import weights as wts
from ..harness.trace import Stretch
from ..reference import processes as ref_proc
from ..reference import so3 as ref_so3
from ..reference.schedule import Schedule


def build(cfg: dict, seed: int, device: torch.device, fam, clock=None) -> dict:
    """The denoiser (evaluation mode), the process, the poses and their
    projection, from the seed; ``clock`` (``util.Clock``) times the
    phases."""
    clock = clock or util.Clock()
    torch.empty(0, device=device)
    clock.mark("imports_device_context")
    w = wts.make(fam.param_spec(cfg), util.derive(seed, util.WEIGHTS), device)
    util.sync(device)
    clock.mark("weights")
    model = fam.build_model(cfg, w, device).eval()
    del w
    clock.mark("model")
    process = fam.build_process(cfg, device)
    clock.mark("process_tables")
    batch = fam.sample_inputs(cfg, util.rng(seed, util.DATA), device)
    out = {"model": model, "process": process, "batch": batch, "proj": fam.projection(batch)}
    clock.mark("inputs")
    return out


def call(b: dict, cfg: dict, traffic: dict, gen_seed: int, keep: bool = True) -> dict:
    """One chain from the generator seeded ``gen_seed``: the answer on the
    host and, with ``keep``, each state and denoiser output by reference."""
    gen = torch.Generator(device=b["batch"]["rec_mask"].device).manual_seed(gen_seed)
    model, proj = b["model"], b["proj"]
    xs, vs = [], []

    def denoise(x, t):
        out = model(x, t)
        if keep:
            vs.append(out)
        return out

    def project(x):
        if keep:
            xs.append(x)
        return proj(x)

    aff = b["process"].ddim_sample_loop(denoise, gen, (cfg["batch"],), traffic["sampler_steps"], project)
    return {"xs": xs, "vs": vs, "rot": aff.rot.cpu(), "shift": aff.shift.cpu()}


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device: torch.device, t0: float, fam) -> dict:
    clock = util.Clock(t0)
    b = build(cfg, seed, device, fam, clock)
    calls, stretch = [], None
    last_traced = traffic["trace_after_calls"] + traffic["trace_calls"]
    with torch.inference_mode():
        call(b, cfg, traffic, util.derive(seed, util.WARMUP), keep=False)  # every shape once
        util.sync(device)
        clock.mark("warm_call")
        t_start = time.perf_counter()
        while True:
            if trace and len(calls) == traffic["trace_after_calls"]:
                stretch = Stretch().__enter__()
            calls.append(call(b, cfg, traffic, util.derive(seed, util.CALL, len(calls))))
            if stretch is not None and len(calls) == last_traced:
                stretch.__exit__(None, None, None)
            if time.perf_counter() - t_start >= seconds and (not trace or len(calls) > last_traced):
                break
        t_end = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    failed = sum(1 for c in calls if not (torch.isfinite(c["rot"]).all() and torch.isfinite(c["shift"]).all()))
    batch = b["batch"]
    del b
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    picked = checked_calls(seed, len(calls), traffic["check_calls"])
    numbers = check(cfg, traffic, seed, fam, batch, {i: calls[i] for i in picked}, device)
    out = {"attempted": len(calls), "failed": failed, "memory_peak_bytes": peak, "numbers": numbers,
           "setup_phases": clock.phases,
           "e2e": {"setup_s": t_start - t0, "sample_s": (t_end - t_start) / len(calls),
                   "peak_mem_gib": peak / 2 ** 30}}
    if stretch is not None:
        s = stretch.summary()
        n, steps = traffic["trace_calls"], traffic["sampler_steps"]
        out["trace"] = dict(s, calls=n, sampler_steps=n * steps, forwards=n * (steps + 1),
                            flops_forward=fam.forward_flops(cfg),
                            wall_per_call_s=(t_end - t_start - s["held_s"]) / (len(calls) - n))
    return out


def checked_calls(seed: int, n: int, count: int) -> list:
    """The last call and ``count - 1`` others drawn from the seed."""
    others = util.rng(seed, util.CHECK).permutation(n - 1)[:count - 1] if n > 1 else []
    return sorted({n - 1, *[int(i) for i in others]})


def _pose_gap(rot_p, shift_p, rots_r, shift_r) -> float:
    """The larger of the widest rotation angle (rad; the nearer of the
    reference's candidates per pose) and the widest shift gap over
    1 + the widest reference shift."""
    ang = torch.stack([ref_so3.angle_between(rot_p, r.to(rot_p.dtype)) for r in rots_r]).min(0).values.max()
    sh = (shift_p - shift_r).abs().max() / (1 + shift_r.abs().max())
    return float(torch.maximum(ang, sh))


def check(cfg, traffic, seed, fam, batch, calls: dict, device, control: bool = False,
          dtype=torch.float64) -> dict:
    """Over ``calls``: model_gap, the RMS of the denoiser's gap to the
    reference over the RMS of the reference's output, over every step and
    pose of the calls, and step_gap, ``_pose_gap`` of
    the start against the reference's draw, of each step against the
    reference's step from the program's state and output, and of the
    answer against the reference's x_0 estimate, the worst of them, each
    step's over its conditioning sqrt(acp_prev / acp_t): a step takes the
    rotation's log to the power 1 / sqrt(acp_t) and back by sqrt(acp_prev),
    so it multiplies its input's rounding by that (654 at t = 999).

    ``control``: the reference computed in the precisions below the
    configuration's stands in the program's place at the program's
    states: its denoiser with fp8 products, its steps in float32 with TF32
    products."""
    from ..reference import lowp

    params = {k: v.to(dtype) for k, v in
              wts.make(fam.param_spec(cfg), util.derive(seed, util.WEIGHTS), device).items()}
    sched = Schedule(cfg["timesteps"], device)
    grid = sched.ddim_grid(traffic["sampler_steps"])
    b, clip = cfg["batch"], cfg["clip_shift"]
    sq_gap = sq_ref = step = 0.0
    with torch.no_grad():
        for i, c in calls.items():
            if not control:
                gen = torch.Generator(device=device).manual_seed(util.derive(seed, util.CALL, i))
                rot0 = ref_so3.haar_qr(torch.randn((b, 3, 3), generator=gen, device=device).to(dtype))
                shift0 = torch.randn((b, 3), generator=gen, device=device).to(dtype)
                x0 = c["xs"][0]
                step = max(step, _pose_gap(x0.rot.to(dtype), x0.shift.to(dtype), [rot0], shift0))
            for j, (x, v) in enumerate(zip(c["xs"], c["vs"])):
                rot, shift = x.rot.to(dtype), x.shift.to(dtype)
                t = torch.full((b,), grid[j], dtype=torch.long, device=device)
                v_p = torch.cat((v.rot_g, v.shift_g), -1).to(dtype)
                v_r = fam.ref_denoise(cfg, params, batch, rot, shift, t)
                v_m = fam.ref_denoise(cfg, params, batch, rot, shift, t, lowp.FP8) if control else v_p
                sq_gap += float((v_m - v_r).pow(2).sum())
                sq_ref += float(v_r.pow(2).sum())
                last = j == len(grid) - 1
                t_prev = torch.full((b,), grid[min(j + 1, len(grid) - 1)], dtype=torch.long, device=device)
                if last:
                    r_rots, r_sh = ref_proc.se3_x0(rot, shift, v_p, t, sched, clip)
                    r_rots = [r_rots]
                else:
                    r_rots, r_sh = ref_proc.se3_ddim_step(rot, shift, v_p, t, t_prev, sched, clip)
                if control:  # the step in float32 with TF32 products, from the same state and output
                    f = torch.float32
                    args = (rot.to(f), shift.to(f), v_p.to(f), t)
                    if last:
                        p_rot, p_sh = ref_proc.se3_x0(*args, sched, clip, lowp.TF32)
                    else:
                        p_rots, p_sh = ref_proc.se3_ddim_step(*args, t_prev, sched, clip, lowp.TF32)
                        p_rot = p_rots[0]
                elif last:
                    p_rot, p_sh = c["rot"].to(device), c["shift"].to(device)
                else:
                    p_rot, p_sh = c["xs"][j + 1].rot, c["xs"][j + 1].shift
                cond = float(sched.sqrt_acp[grid[min(j + 1, len(grid) - 1)]] / sched.sqrt_acp[grid[j]])
                step = max(step, _pose_gap(p_rot.to(dtype), p_sh.to(dtype), r_rots, r_sh) / max(cond, 1.0))
    return {"model_gap": (sq_gap / sq_ref) ** 0.5, "step_gap": step}
