"""Jigsaw translation toy: R^2 projected diffusion over rendered images
(counterpart of ``diffusion_extensions_tpu/experiments/jigsaw.py``):

    python -m diffusion_extensions_tpu_torch.experiments.jigsaw --steps 40000
    python -m diffusion_extensions_tpu_torch.experiments.jigsaw --test [--plot]

Training: ``CoordConv(size)`` learns the l2 noise loss of
``ProjectedGaussianDiffusion`` on the circle's position, seen through the
puzzle's renderer (``data/jigsaw.render_jigsaw``, the projection, run inside
the step on the state's device).  Step ``i`` draws a fresh puzzle from seed
``seed * 1_000_003 + i``, as the JAX driver does; the puzzles of up to
``PUZZLE_BLOCK`` steps are drawn on the host and copied to the device at
once, so a step reads its square, circle and x_0 as device tensors and the
host's draw stays off the device's critical path.  Adam through
``train/optim.py``, one eager step a call.  Checkpoints go to the directory
``--ckpt`` every ``--ckpt-every`` steps and at ``--steps``; ``--resume``
continues from the newest one, to the bit.  Convolutions use cuDNN's
deterministic algorithms, which that needs.

``--test`` runs the ``--timesteps``-step ancestral chain over
``--eval-batch`` samples on the puzzle of seed ``seed + 1234``, prints the
circle's placement error (median, mean and p90 in pixels) and writes the
samples to ``--out-dir`` (default ``torch_results/``) as
``torch_jigsaw_samples.npy`` and the numbers as ``torch_jigsaw.json``;
``--plot`` adds a grid of the final frames there (needs matplotlib).  Its
weights are the newest checkpoint of ``--ckpt`` or a bare ``torch.save``
state dict of CoordConv; without either the seeded init is evaluated.
Runs on the card unless ``--device`` says otherwise.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..data.jigsaw import JigsawPuzzle, puzzle_rows, render_jigsaw
from ..models.coordconv import CoordConv
from ..parallel.dp import make_dp_train_step
from ..processes.r3 import ProjectedGaussianDiffusion
from ..train.loop import MetricLogger, Throughput
from ..train.optim import make_optimizer
from ..train.state import TrainState, load_eval_weights, restore_checkpoint, save_checkpoint
from .bingham import due

STEPS_DEFAULT = 40_000
BATCH_DEFAULT = 256
PUZZLE_BLOCK = 1000
DIVERGED_PX = 10.0  # a sample further than this from the solution has diverged


def build(args, device):
    """(model, process); the model's init is seeded by ``args.seed``."""
    torch.manual_seed(args.seed)
    model = CoordConv(size=args.size, dim=16).to(device)
    process = ProjectedGaussianDiffusion(args.timesteps, loss_type="l2", device=device)
    return model, process


def make_loss_fn(model, process, batch: int, size: int):
    """``loss_fn(generator, puzzle)``: the l2 loss of the puzzle's solution,
    broadcast over ``batch``; ``puzzle`` is a (6,) row of ``puzzle_rows``
    on the model's device, or ``(row, t, noise)`` to fix the timesteps and
    the noise."""

    def loss_fn(generator, puzzle):
        row, t, noise = puzzle if isinstance(puzzle, (tuple, list)) else (puzzle, None, None)
        square, circle, x0 = row[0:2], row[2:4], row[4:6]

        def projection(x):
            return render_jigsaw(x, square, circle, size)

        return process.loss(model, generator, x0.expand(batch, 2), projection=projection,
                            t=t, noise=noise)

    return loss_fn


def step_seeds(seed: int, start: int, stop: int) -> range:
    """The puzzle seed of each training step in [start, stop)."""
    return range(seed * 1_000_003 + start, seed * 1_000_003 + stop)


def train(args) -> TrainState:
    device = resolve_device(args.device)
    model, process = build(args, device)
    optimizer = make_optimizer(model.named_parameters(), args.lr)
    state = TrainState(model, optimizer, torch.Generator(device=device).manual_seed(args.seed))
    if args.resume:
        state = restore_checkpoint(args.ckpt, state)
    step_fn = make_dp_train_step(make_loss_fn(model, process, args.batch, args.size), model,
                                 optimizer)
    logger = MetricLogger(jsonl_path=args.log, print_every=args.print_every)
    meter = Throughput()
    block, start = None, state.step
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for i in range(state.step, args.steps):
            if block is None or i - start == len(block):
                start = i
                stop = min(i + PUZZLE_BLOCK, args.steps)
                rows = puzzle_rows(step_seeds(args.seed, i, stop), args.size)
                block = torch.from_numpy(rows).to(device)
            state, metrics = step_fn(state, block[i - start])
            meter.tick()
            if due(i + 1, args.print_every, 1, args.steps):
                logger.log(i + 1, {"loss": float(metrics["loss"]),
                                   "steps_per_sec": meter.steps_per_sec or float("nan")})
            if due(i + 1, args.ckpt_every, 1, args.steps):
                save_checkpoint(args.ckpt, state, step=i + 1)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        logger.close()
    return state


def placement_px(samples: np.ndarray, x_0: np.ndarray, size: int) -> np.ndarray:
    """Distance of each sample from the solution, in pixels (state * size / 8)."""
    return np.linalg.norm(samples - x_0[None], axis=-1) * size / 8.0


@torch.inference_mode()
def test(args) -> dict:
    """One chain of ``--eval-batch`` samples; returns the record written to
    ``--out-dir``."""
    device = resolve_device(args.device)
    model, process = build(args, device)
    model.eval()
    if not load_eval_weights(model, args.ckpt, device):
        print(f"warning: no checkpoint found at {args.ckpt}; evaluating untrained model")
    jp = JigsawPuzzle(size=args.size, seed=args.seed + 1234)
    gen = torch.Generator(device=device).manual_seed(args.seed + 2)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = process.p_sample_loop(model, gen, (args.eval_batch, 2), projection=jp)
    sync()
    dt = time.perf_counter() - t0
    samples = out.cpu().numpy()
    err = placement_px(samples, jp.x_0, args.size)
    pct = {"median": float(np.median(err)), "mean": float(err.mean()),
           "p90": float(np.percentile(err, 90))}
    print(f"final circle-position error over {args.eval_batch} samples: "
          f"median={pct['median']:.2f}px mean={pct['mean']:.2f}px p90={pct['p90']:.2f}px")
    print(f"sampled in {dt:.2f}s ({args.timesteps} model evals)")
    record = {"count": args.eval_batch, "sample_seconds": dt, "model_evals": args.timesteps,
              "finite": bool(np.isfinite(samples).all()), "px": pct,
              "diverged": int((~(err <= DIVERGED_PX)).sum()), "errors_px": err.tolist()}
    os.makedirs(args.out_dir, exist_ok=True)
    np.save(os.path.join(args.out_dir, "torch_jigsaw_samples.npy"), samples)
    with open(os.path.join(args.out_dir, "torch_jigsaw.json"), "w") as f:
        json.dump(record, f)
    if args.plot:
        plot_frames(jp(out[:16]).cpu().numpy(), args)
    return record


def plot_frames(frames: np.ndarray, args) -> str:
    """A 4 x 4 grid of final frames (the reference's sampled frames), x to
    the right, y up; written to ``--plot`` or ``--out-dir``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(4, 4, figsize=(8, 8))
    for ax, frame in zip(axes.ravel(), frames):
        ax.imshow(np.transpose(frame, (2, 1, 0)), origin="lower")  # (3, x, y) -> (y, x, 3)
    for ax in axes.ravel():
        ax.set_axis_off()
    path = (args.plot if isinstance(args.plot, str)
            else os.path.join(args.out_dir, "torch_jigsaw_frames.png"))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    print(f"wrote {path}")
    return path


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Jigsaw translation toy")
    p.add_argument("--batch", type=int, default=BATCH_DEFAULT)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--steps", type=int, default=STEPS_DEFAULT)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--timesteps", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt", type=str, default="weights/jigsaw",
                   help="checkpoint directory (--test also takes a bare torch.save state "
                        "dict of CoordConv)")
    p.add_argument("--ckpt-every", dest="ckpt_every", type=int, default=1000)
    p.add_argument("--print-every", dest="print_every", type=int, default=10)
    p.add_argument("--log", type=str, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--debug-nans", dest="debug_nans", action="store_true",
                   help="enable torch.autograd.set_detect_anomaly")
    p.add_argument("--test", action="store_true")
    p.add_argument("--eval-batch", dest="eval_batch", type=int, default=64)
    p.add_argument("--plot", nargs="?", const=True, default=False,
                   help="save a grid of final sampled frames (optional path; default "
                        "<out-dir>/torch_jigsaw_frames.png)")
    p.add_argument("--out-dir", dest="out_dir", type=str, default="torch_results",
                   help="where --test writes torch_jigsaw_samples.npy and torch_jigsaw.json")
    p.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    with torch.autograd.set_detect_anomaly(args.debug_nans):
        return test(args) if args.test else train(args)


if __name__ == "__main__":
    main()
