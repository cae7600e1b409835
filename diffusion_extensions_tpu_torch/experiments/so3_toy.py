"""Toy SO(3) diffusion on two rotation modes, +-90 deg about z (counterpart
of ``diffusion_extensions_tpu/experiments/so3_toy.py``):

    python -m diffusion_extensions_tpu_torch.experiments.so3_toy --steps 5000
    python -m diffusion_extensions_tpu_torch.experiments.so3_toy --test [--sampler ddim]

Training draws ``--batch`` target rotations a step, half from each mode in
expectation, takes the skew-vec loss of ``SO3Diffusion`` through
``RotPredict(d_model=65, out_type="skewvec")`` and applies Adam;
``--steps-per-call K`` runs K steps a call (a CUDA graph replayed a step on
the card).  Checkpoints go to the directory ``--ckpt`` (default
``weights/so3_toy``) every ``--ckpt-every`` steps and at ``--steps``.

``--test`` draws ``--eval-batch`` rotations with ``--sampler`` (the
1000-step ancestral chain from the eps = 1 prior, DDIM, or the
exact-transport probability-flow integrator, ``method="flow"``), prints the
percentiles of the angle to the nearest mode and writes them, with the
seconds and model evaluations, to ``--out-dir`` (default
``torch_results/``) as ``torch_so3_toy_{sampler}.json``; ``--plot`` traces
the ancestral chain's Euler angles into a figure there.  Its weights are
the newest checkpoint of ``--ckpt`` (or a bare ``torch.save`` state dict of
RotPredict); without either the seeded init is evaluated.  Runs on the card
unless ``--device`` says otherwise.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .. import obs, resolve_device
from ..data.synthetic import sample_two_mode_batch, two_mode_rotations
from ..models.rot_predict import RotPredict
from ..ops.metrics import rmat_dist
from ..ops.so3 import rmat_to_euler
from ..parallel.dp import make_dp_train_step
from ..processes.so3 import SO3Diffusion
from ..train.loop import MetricLogger, Throughput
from ..train.optim import make_optimizer
from ..train.state import TrainState, load_eval_weights, restore_checkpoint, save_checkpoint
from .bingham import due

PERCENTILES = (1, 5, 10, 50, 90, 95, 99)


def build(args, device):
    """(model, process); the model's init is seeded by ``args.seed``."""
    torch.manual_seed(args.seed)
    model = RotPredict(d_model=args.d_model, out_type="skewvec").to(device)
    process = SO3Diffusion.create(args.timesteps, loss_type="skewvec", device=device)
    return model, process


def make_loss_fn(model, process):
    """``loss_fn(generator, batch)``: the skew-vec loss of the target
    rotations ``batch`` (B, 3, 3), or of ``(rotations, t, noise)`` to fix
    the timesteps and the noise."""

    def loss_fn(generator, batch):
        x0, t, noise = batch if isinstance(batch, (tuple, list)) else (batch, None, None)
        return process.loss(model, generator, x0, t=t, noise=noise)

    return loss_fn


def train(args) -> TrainState:
    device = resolve_device(args.device)
    model, process = build(args, device)
    optimizer = make_optimizer(model.named_parameters(), args.lr)
    state = TrainState(model, optimizer, torch.Generator(device=device).manual_seed(args.seed))
    if args.resume:
        state = restore_checkpoint(args.ckpt, state)

    K = max(min(args.steps_per_call, args.steps), 1)
    step_fn = make_dp_train_step(make_loss_fn(model, process), model, optimizer,
                                 steps_per_call=K)
    data_gen = torch.Generator(device=device).manual_seed(args.seed + 1)

    def make_batch(k: int) -> torch.Tensor:
        rots = sample_two_mode_batch(data_gen, k * args.batch)
        return rots.reshape(k, args.batch, 3, 3) if K > 1 else rots

    logger = MetricLogger(jsonl_path=args.log, print_every=args.print_every)
    meter = Throughput()
    try:
        i = state.step
        while i < args.steps:
            k = min(K, args.steps - i)  # the tail is exact
            state, metrics = step_fn(state, make_batch(k))
            for _ in range(k):
                meter.tick()
            i += k
            if due(i, args.print_every, k, args.steps):
                logger.log(i, {"loss": float(metrics["loss"]),
                               "steps_per_sec": meter.steps_per_sec or float("nan")})
            if due(i, args.ckpt_every, k, args.steps):
                save_checkpoint(args.ckpt, state, step=i)
    finally:
        logger.close()
    return state


def mode_angles(samples: torch.Tensor) -> np.ndarray:
    """Angle (rad) from each sample to the nearest of the two modes:
    ``rmat_dist`` is sqrt(2) theta, scaled back as the reference does."""
    modes = two_mode_rotations(samples.device)
    d0 = rmat_dist(samples, modes[0][None]) * 0.70710678118
    d1 = rmat_dist(samples, modes[1][None]) * 0.70710678118
    return torch.minimum(d0, d1).cpu().numpy()


@torch.inference_mode()
def test(args) -> dict:
    """One chain of ``--eval-batch`` rotations; returns the record written
    to ``--out-dir``."""
    device = resolve_device(args.device)
    model, process = build(args, device)
    model.eval()
    if not load_eval_weights(model, args.ckpt, device):
        print(f"warning: no checkpoint found at {args.ckpt}; sampling from untrained model")
    gen = torch.Generator(device=device).manual_seed(args.seed + 2)
    shape = (args.eval_batch,)
    launches0 = obs.counter("ops.igso3.launches")
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    traj = None
    if args.plot:
        samples, traj = process.p_sample_loop(model, gen, shape, return_trajectory=True)
    elif args.sampler == "ddim":
        samples = process.ddim_sample_loop(model, gen, shape, num_steps=args.sampler_steps)
    elif args.sampler == "pf":
        samples = process.pf_sample_loop(model, gen, shape, num_steps=args.sampler_steps,
                                         method="flow")
    else:
        samples = process.p_sample_loop(model, gen, shape)
    sync()
    dt = time.perf_counter() - t0
    best = mode_angles(samples)
    vals = np.percentile(best, PERCENTILES)
    n_evals = args.timesteps if args.sampler == "ancestral" else args.sampler_steps
    print(f"sampled {args.eval_batch} rotations in {dt:.2f}s "
          f"({args.sampler}, {n_evals} model evals)")
    print("angle-to-nearest-mode percentiles (rad):")
    print("  " + "  ".join(f"{p}%: {v:.4f}" for p, v in zip(PERCENTILES, vals)))
    record = {"sampler": args.sampler, "sampler_steps": args.sampler_steps,
              "count": args.eval_batch, "sample_seconds": dt, "model_evals": n_evals,
              "launches": obs.counter("ops.igso3.launches") - launches0,
              "finite": bool(torch.isfinite(samples).all()),
              "percentiles": dict(zip(map(str, PERCENTILES), map(float, vals))),
              "angles": best.tolist()}
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, f"torch_so3_toy_{args.sampler}.json"), "w") as f:
        json.dump(record, f)
    if traj is not None:
        plot_traces(traj, args)
    return record


def plot_traces(traj: torch.Tensor, args, max_chains: int = 64) -> str:
    """Euler-angle traces of the first ``max_chains`` chains over the
    reverse process (the reference's convergence figure), written to
    ``--plot`` or ``--out-dir``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..viz.colors import BLUE, GREEN, ORANGE
    from ..viz.mpl import setup_pi_axis

    t_axis = np.arange(traj.shape[0])[::-1]
    series = [s.cpu().numpy() for s in rmat_to_euler(traj[:, :max_chains])]
    fig, axlist = plt.subplots(nrows=3, ncols=1, sharex=True)
    for ax, values, c in zip(axlist, series, (BLUE, ORANGE, GREEN)):
        ax.plot(t_axis, values, alpha=0.2, c=c, lw=0.7)
        setup_pi_axis(ax)
    axlist[2].axhline(np.pi / 2, color="grey", ls="-", lw=0.5)
    axlist[2].axhline(-np.pi / 2, color="grey", ls="-", lw=0.5)
    axlist[2].set_xlabel("Reverse process steps")
    axlist[1].set_ylabel("Angle")
    out = (args.plot if isinstance(args.plot, str)
           else os.path.join(args.out_dir, "torch_so3_toy_traces.png"))
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    fig.savefig(out, dpi=150, bbox_inches="tight")
    plt.close(fig)
    print(f"wrote {out}")
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Toy SO(3) diffusion")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--steps", type=int, default=400_000)
    p.add_argument("--steps-per-call", dest="steps_per_call", type=int, default=16,
                   help="run K optimizer steps per call of the step function")
    p.add_argument("--d_model", type=int, default=65)
    p.add_argument("--timesteps", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt", type=str, default="weights/so3_toy",
                   help="checkpoint directory (--test also takes a bare torch.save state "
                        "dict of RotPredict)")
    p.add_argument("--ckpt-every", dest="ckpt_every", type=int, default=1000)
    p.add_argument("--print-every", dest="print_every", type=int, default=10)
    p.add_argument("--log", type=str, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--debug-nans", dest="debug_nans", action="store_true",
                   help="enable torch.autograd.set_detect_anomaly")
    p.add_argument("--test", action="store_true")
    p.add_argument("--sampler", choices=("ancestral", "ddim", "pf"), default="ancestral",
                   help="reverse chain for --test: ancestral 1000-step, DDIM, or the "
                        "exact-transport probability-flow integrator (method='flow')")
    p.add_argument("--sampler-steps", dest="sampler_steps", type=int, default=50,
                   help="model evals for ddim/pf samplers")
    p.add_argument("--eval-batch", dest="eval_batch", type=int, default=512)
    p.add_argument("--plot", nargs="?", const=True, default=False,
                   help="with --test: Euler-angle traces of the ancestral chain (optional "
                        "path; default <out-dir>/torch_so3_toy_traces.png; needs matplotlib)")
    p.add_argument("--out-dir", dest="out_dir", type=str, default="torch_results",
                   help="where --test writes torch_so3_toy_<sampler>.json")
    p.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    args = p.parse_args(argv)
    if args.plot and args.sampler != "ancestral":
        p.error("--plot traces the ancestral chain; it takes no other --sampler")
    return args


def main(argv=None):
    args = parse_args(argv)
    with torch.autograd.set_detect_anomaly(args.debug_nans):
        return test(args) if args.test else train(args)


if __name__ == "__main__":
    main()
