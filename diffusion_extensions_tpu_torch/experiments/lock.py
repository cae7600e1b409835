"""Gimbal-lock ablation, SO(3) against Euler-angle diffusion on a geodesic
segment through the gimbal lock (counterpart of
``diffusion_extensions_tpu/experiments/lock.py``):

    python -m diffusion_extensions_tpu_torch.experiments.lock --param so3 --steps 100000
    python -m diffusion_extensions_tpu_torch.experiments.lock --param euler --test

Data: so3_lerp(R(0, pi/3, 0), R(0, 2 pi/3, 0), U(0, 1)), rotations about y
whose Euler y crosses pi/2.  ``--param so3`` trains
``RotPredict(255, "skewvec", "resnet")`` with the skew-vec loss of
``SO3Diffusion``; ``--param euler`` trains ``EulerRotPredict(255)`` with the
l2 loss of ``GaussianDiffusion`` on the XYZ Euler decomposition of the same
data (whose sampler clips x0 to [-1, 1], as the reference's does).  A step
whose loss or gradient is not finite leaves the weights alone, as the
reference's trainer skips it; that check waits for the device, so steps
run eagerly.  Checkpoints go to ``--ckpt`` (default ``weights/lock_{param}``).

``--test`` samples ``--eval-batch`` rotations with the 1000-step ancestral
chain from Haar-QR matrices (the Euler arm: their Euler angles), reports the
mean |axis . y| of the samples (1 = on the segment's axis), their mean
angle and the fraction within 0.1 rad of [pi/3, 2 pi/3], and writes the
samples to ``--out-dir`` (default ``torch_results/``) as
``torch_lock_samples_{param}.npy`` and the numbers as
``torch_lock_{param}.json`` (``--plot``: the final frames on the sphere,
``torch_lock_sphere_{param}.png``).  Runs on the card unless ``--device``
says otherwise.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..data.synthetic import sample_lock_batch
from ..models.rot_predict import EulerRotPredict, RotPredict
from ..ops.so3 import euler_to_rmat, haar_rotations, rmat_to_aa, rmat_to_euler
from ..parallel.dp import make_dp_train_step
from ..processes.r3 import GaussianDiffusion
from ..processes.so3 import SO3Diffusion
from ..train.loop import MetricLogger, Throughput
from ..train.optim import make_optimizer
from ..train.state import TrainState, load_eval_weights, restore_checkpoint, save_checkpoint


def build(args, device):
    """(model, process) of the arm; the model's init is seeded by ``args.seed``."""
    torch.manual_seed(args.seed)
    if args.param == "so3":
        model = RotPredict(d_model=255, out_type="skewvec", variant="resnet")
        process = SO3Diffusion.create(args.timesteps, loss_type="skewvec", device=device)
    else:
        model = EulerRotPredict(d_model=255)
        process = GaussianDiffusion.create(args.timesteps, loss_type="l2", device=device)
    return model.to(device), process


def lock_batch(generator: torch.Generator, batch: int, param: str) -> torch.Tensor:
    """Segment samples as the arm sees them: rotations, or their Euler
    angles (B, 3)."""
    rots = sample_lock_batch(generator, batch)
    return rots if param == "so3" else torch.stack(rmat_to_euler(rots), dim=-1)


def make_loss_fn(model, process):
    """``loss_fn(generator, batch)``: the arm's loss of the clean states
    ``batch``, or of ``(states, t, noise)`` to fix the timesteps and the
    noise."""

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
    step_fn = make_dp_train_step(make_loss_fn(model, process), model, optimizer,
                                 skip_nonfinite=True)
    data_gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    logger = MetricLogger(jsonl_path=args.log, print_every=args.print_every)
    meter = Throughput()
    try:
        for i in range(state.step, args.steps):
            state, metrics = step_fn(state, lock_batch(data_gen, args.batch, args.param))
            meter.tick()
            if (i + 1) % args.print_every == 0:
                logger.log(i + 1, {"loss": float(metrics["loss"]),
                                   "steps_per_sec": meter.steps_per_sec or float("nan")})
            if (i + 1) % args.ckpt_every == 0 or (i + 1) == args.steps:
                save_checkpoint(args.ckpt, state)
    finally:
        logger.close()
    return state


def sample(model, process, args, device) -> torch.Tensor:
    """``--eval-batch`` rotations from the ancestral chain: the so3 arm from
    Haar-QR matrices (``init="qr"`` on the unprojected process), the Euler
    arm from their Euler angles, decoded at the end."""
    gen = torch.Generator(device=device).manual_seed(args.seed + 2)
    if args.param == "so3":
        return process.p_sample_loop(model, gen, (args.eval_batch,), init="qr")
    r0 = haar_rotations(torch.Generator(device=device).manual_seed(args.seed + 3),
                        (args.eval_batch,))
    x_init = torch.stack(rmat_to_euler(r0), dim=-1)
    eul = process.p_sample_loop(model, gen, (args.eval_batch, 3), x_init=x_init)
    return euler_to_rmat(eul[..., 0], eul[..., 1], eul[..., 2])


def segment_stats(rots: torch.Tensor) -> dict:
    """How well the samples stay on the segment, pure-y rotations with angle
    in [pi/3, 2 pi/3]: mean |axis . y|, mean angle, and the fraction of
    angles within 0.1 rad of that range."""
    axis, angle = rmat_to_aa(rots)
    y_align = axis[:, 1].abs().cpu().numpy()
    ang = angle[:, 0].cpu().numpy()
    in_range = ((ang > math.pi / 3 - 0.1) & (ang < 2 * math.pi / 3 + 0.1)).mean()
    return {"axis_y_mean": float(y_align.mean()), "angle_mean": float(ang.mean()),
            "in_range": float(in_range)}


@torch.inference_mode()
def test(args) -> dict:
    """Samples and the segment statistics; returns the record written to
    ``--out-dir``."""
    device = resolve_device(args.device)
    model, process = build(args, device)
    model.eval()
    if not load_eval_weights(model, args.ckpt, device):
        print(f"warning: no checkpoint found at {args.ckpt}; sampling from untrained model")
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    rots = sample(model, process, args, device)
    sync()
    stats = segment_stats(rots)
    record = {"param": args.param, "count": args.eval_batch,
              "sample_seconds": time.perf_counter() - t0,
              "finite": bool(torch.isfinite(rots).all()), **stats}
    print(f"param={args.param}  samples={args.eval_batch}")
    print(f"  |axis.y| mean={stats['axis_y_mean']:.4f}  (1.0 = perfectly on-axis)")
    print(f"  angle mean={stats['angle_mean']:.4f} rad  in-range frac={stats['in_range']:.3f}")
    os.makedirs(args.out_dir, exist_ok=True)
    np.save(os.path.join(args.out_dir, f"torch_lock_samples_{args.param}.npy"),
            rots.cpu().numpy())
    with open(os.path.join(args.out_dir, f"torch_lock_{args.param}.json"), "w") as f:
        json.dump(record, f)
    if args.plot:
        from ..viz.sphere import plot_rotation_frames

        out = os.path.join(args.out_dir, f"torch_lock_sphere_{args.param}.png")
        plot_rotation_frames(rots, out_path=out,
                             title=f"lock suite final frames ({args.param})")
        print(f"wrote {out}")
    return record


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Gimbal-lock ablation")
    p.add_argument("--param", choices=["so3", "euler"], default="so3")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--steps", type=int, default=100_000)
    p.add_argument("--timesteps", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt", type=str, default=None,
                   help="checkpoint directory, default weights/lock_{param} (--test also "
                        "takes a bare torch.save state dict of the arm's model)")
    p.add_argument("--ckpt-every", dest="ckpt_every", type=int, default=1000)
    p.add_argument("--print-every", dest="print_every", type=int, default=10)
    p.add_argument("--log", type=str, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--debug-nans", dest="debug_nans", action="store_true",
                   help="enable torch.autograd.set_detect_anomaly")
    p.add_argument("--test", action="store_true")
    p.add_argument("--eval-batch", dest="eval_batch", type=int, default=512)
    p.add_argument("--plot", action="store_true",
                   help="with --test: the final frames on the sphere, "
                        "<out-dir>/torch_lock_sphere_<param>.png (needs matplotlib)")
    p.add_argument("--out-dir", dest="out_dir", type=str, default="torch_results",
                   help="where --test writes torch_lock_samples_<param>.npy and "
                        "torch_lock_<param>.json")
    p.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    args = p.parse_args(argv)
    if args.ckpt is None:
        args.ckpt = f"weights/lock_{args.param}"
    return args


def main(argv=None):
    args = parse_args(argv)
    with torch.autograd.set_detect_anomaly(args.debug_nans):
        return test(args) if args.test else train(args)


if __name__ == "__main__":
    main()
