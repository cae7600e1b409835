"""Protein heterodimer docking by SE(3) projected diffusion (counterpart of
``diffusion_extensions_tpu/experiments/protein.py``):

    python -m diffusion_extensions_tpu_torch.experiments.protein --se3 --steps 5000
    python -m diffusion_extensions_tpu_torch.experiments.protein --se3 --test

Training: the state is the identity transform and ``ProtNet`` sees the
ligand moved by the noisy transform about its centroid (``ProtProjection``);
a step takes the grad_mse loss of ``ProjectedSE3Diffusion`` and applies Adam.
Batches are pairs padded on the host to the dataset's longest chains,
Haar-augmented (``make_batches``: the JAX driver's numpy stream, so its
batches are the same bits) and moved to the device in one copy.
``--steps-per-call K`` runs K steps on K distinct fresh batches per call
(a CUDA graph replayed a step on the card); the last call is cut so that
exactly ``--steps`` steps run.  ``--epoch-accum`` sums the gradients over an
epoch and takes one optimizer step, as the reference did.

``--test`` samples SAMPLES docking transforms per pose with ``--sampler``
(the 1000-step ancestral chain, DDIM, probability flow, or Picard DDIM),
prints the angle and shift percentile table and writes the samples to
``--out-dir`` (default ``torch_results/``).  Its weights are the newest
checkpoint of the directory ``--ckpt`` (or a bare ``torch.save`` state dict
of ProtNet, which ``convert.protnet_params_from_flax`` makes from a JAX
checkpoint); without either the seeded init is evaluated.

Falls back to 16 synthetic pairs when ``data/BPTI_dock`` is absent.  Runs on
the card unless ``--device`` says otherwise.  The Euler arm (``--se3`` off)
is not ported yet.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import warnings

import numpy as np
import torch

from .. import resolve_device
from ..data.pdb import (
    ProtPairDataset,
    move_prots_np,
    pad_prot_batch,
    random_affine_np,
    synthetic_prot_pair,
    to_device,
)
from ..models.projections import ProtBatch, ProtProjection
from ..models.protnet import CONV_IMPLS, ProtNet
from ..ops import igso3_cuda
from ..ops.se3 import AffineT
from ..ops.so3 import rmat_to_aa
from ..parallel.dp import make_dp_train_step
from ..processes.se3 import ProjectedSE3Diffusion
from ..train.loop import MetricLogger, Throughput
from ..train.optim import add_optim_flags, make_optimizer
from ..train.state import TrainState, load_eval_weights, restore_checkpoint, save_checkpoint

AUGMENT = True
SAMPLES = 4  # samples per pose at evaluation
PERCENTILES = (1, 5, 10, 50, 90, 95, 99)


def load_pairs(args):
    try:
        ds = ProtPairDataset(args.data_root)
        if len(ds) == 0:
            raise FileNotFoundError(args.data_root)
        pairs = [ds[i] for i in range(len(ds))]
        print(f"loaded {len(pairs)} protein pairs from {args.data_root}")
    except (FileNotFoundError, OSError):
        rng = np.random.default_rng(0)
        pairs = [synthetic_prot_pair(rng) for _ in range(16)]
        print(f"{args.data_root} not found; using 16 synthetic protein pairs")
    return pairs


def bucket_lengths(pairs) -> tuple[int, int]:
    """The longest receptor and ligand: every batch is padded to them."""
    return (max(p[0].positions.shape[0] for p in pairs),
            max(p[1].positions.shape[0] for p in pairs))


def check_ported(args) -> None:
    if not args.se3:
        raise SystemExit("the Euler arm of the protein driver (processes/r3.py, "
                         "processes/euler.py) is not ported yet: ROADMAP.md A.2; pass --se3")


def build(args, device):
    """(model, process); the model's init is seeded by ``args.seed``."""
    check_ported(args)
    torch.manual_seed(args.seed)
    with torch.device(device):  # the init draws on the device: seconds less at full width
        model = ProtNet(dim=args.dim, heads=args.heads, t_depth=args.t_depth,
                        c_depth=args.c_depth, bf16=args.bf16, frame_pool=args.frame_pool,
                        cross_depth=args.cross_depth, rel_frame=args.rel_frame,
                        equiv_head=args.equiv_head, conv_impl=args.conv_impl)
    process = ProjectedSE3Diffusion(timesteps=args.timesteps, clip_shift=args.clip_shift,
                                    device=device)
    return model, process


def _augmented(pairs, idx, args, rng):
    chosen = []
    for j in idx:
        rec, lig = pairs[j]
        if AUGMENT and not args.no_augment:
            rot, shift = random_affine_np(rng)
            rec, lig = move_prots_np(rot, shift, (rec, lig))
        chosen.append((rec, lig))
    return chosen


def make_batches(pairs, args, rng):
    """One epoch of augmented, padded numpy batches (the JAX driver's stream:
    a permutation, then one Haar-QR rotation and shift per pair)."""
    order = rng.permutation(len(pairs))
    lr, ll = bucket_lengths(pairs)
    if args.batch > len(pairs):
        # one batch drawn with replacement per epoch
        batches = [rng.choice(len(pairs), size=args.batch, replace=True)]
    else:
        usable = len(order) - len(order) % args.batch  # drop the ragged tail
        batches = [order[i : i + args.batch] for i in range(0, usable, args.batch)]
    for idx in batches:
        yield pad_prot_batch(_augmented(pairs, idx, args, rng), receptor_len=lr, ligand_len=ll)


def batch_stream(pairs, args, rng):
    """Epochs of ``make_batches`` chained into one endless stream of fresh
    poses."""
    while True:
        yield from make_batches(pairs, args, rng)


def stack_batches(batches):
    """K numpy batches -> one with a leading K axis on every leaf."""
    first = batches[0]
    if isinstance(first, tuple):
        return type(first)(*(stack_batches([b[i] for b in batches]) for i in range(len(first))))
    return np.stack(batches)


def true_pos(b: int, device) -> AffineT:
    return AffineT.identity((b,), device=device)


def make_loss_fn(model, process):
    """``loss_fn(generator, batch)``: the process's loss of the identity
    transform seen through the batch.  ``batch`` is a ProtBatch, or
    ``(batch, t, (noise_rot, noise_shift))`` to fix the timesteps and the
    noise."""

    def loss_fn(generator, batch):
        t = noise = None
        if not isinstance(batch, ProtBatch):
            batch, t, noise = batch
            noise = AffineT(*noise)
        b = batch.receptor_mask.shape[0]
        return process.loss(model, generator, true_pos(b, batch.receptor_mask.device),
                            ProtProjection(batch), t=t, noise=noise)

    return loss_fn


def _train_epoch_accum(args, state, loss_fn, pairs, rng, device, logger):
    """Gradients summed over each epoch's batches, one optimizer step per
    epoch; ``state.step`` counts optimizer steps, the loop's counter
    batches (as in the JAX driver)."""
    optimizer = state.optimizer
    step, last_save = state.step, state.step
    while step < args.steps:
        optimizer.zero_grad()
        count = 0
        for batch in make_batches(pairs, args, rng):
            loss = loss_fn(state.generator, to_device(batch, device))
            loss.backward()
            count += 1
            logger.log(step + count, {"loss": loss.detach()})
        optimizer.step()
        state.step += 1
        step += max(count, 1)
        if step - last_save >= args.ckpt_every or step >= args.steps:
            save_checkpoint(args.ckpt, state)
            last_save = step
    return state


def train(args) -> TrainState:
    device = resolve_device(args.device)
    model, process = build(args, device)
    pairs = load_pairs(args)
    rng = np.random.default_rng(args.seed)
    print(f"ProtNet params: {sum(p.numel() for p in model.parameters()) / 1e6:.2f}M")
    optimizer = make_optimizer(
        model.named_parameters(), args.lr, clip=args.clip, schedule=args.lr_schedule,
        total_steps=args.steps, impl=args.opt_impl, state_dtype=args.opt_state_dtype,
    )
    state = TrainState(model, optimizer, torch.Generator(device=device).manual_seed(args.seed))
    if args.resume:
        state = restore_checkpoint(args.ckpt, state)
    K = max(args.steps_per_call, 1)
    if args.epoch_accum and K != 1:
        print("--epoch-accum uses steps_per_call=1")
        K = 1
    loss_fn = make_loss_fn(model, process)
    logger = MetricLogger(jsonl_path=args.log, print_every=args.print_every)
    try:
        if args.epoch_accum:
            return _train_epoch_accum(args, state, loss_fn, pairs, rng, device, logger)
        step_fn = make_dp_train_step(loss_fn, model, optimizer, steps_per_call=K,
                                     log_norms=True, per_layer_norms=args.log_norms_per_layer)

        # the meter's warm-up is a whole number of calls (10 steps at K = 1, 16 at K = 8)
        gen, meter = batch_stream(pairs, args, rng), Throughput(warmup_steps=-(-10 // K) * K)
        step = last_save = state.step
        while step < args.steps:
            k = min(K, args.steps - step)  # the last call is cut: exactly --steps steps
            if K == 1:
                batch = next(gen)
            else:  # k distinct fresh batches on a leading axis
                batch = stack_batches([next(gen) for _ in range(k)])
            state, metrics = step_fn(state, to_device(batch, device))
            for _ in range(k):
                meter.tick()
            prev, step = step, step + k
            if step // args.print_every != prev // args.print_every or step == args.steps:
                row = {k: float(v) for k, v in metrics.items()}  # waits for the device
                row["steps_per_sec"] = meter.steps_per_sec or float("nan")
                logger.log(step, row)
            if step - last_save >= args.ckpt_every or step >= args.steps:
                save_checkpoint(args.ckpt, state)
                last_save = step
        return state
    finally:
        logger.close()


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def print_percentiles(angles: np.ndarray, shifts: np.ndarray, diff_type: str) -> None:
    a_sorted, s_sorted = np.sort(angles), np.sort(shifts)
    idxs = [int(len(a_sorted) * p / 100) for p in PERCENTILES]
    print(f"{len(angles)} samples ({diff_type})")
    print("percentiles " + " ".join(f"& {p}%" for p in PERCENTILES) + r" \\")
    print("angle " + " ".join(f"& {a_sorted[i]:.2f}" for i in idxs) + r" \\")
    print("shift " + " ".join(f"& {s_sorted[i]:.2f}" for i in idxs) + r" \\")


@torch.inference_mode()
def test(args) -> dict:
    """SAMPLES docking transforms per pose; returns the record written to
    ``--out-dir``: angles and shifts, ``sample_seconds`` (sampling only, up
    to the device's last op), ``model_evals`` (denoiser calls per chain),
    ``launches`` (IGSO(3) kernel launches), the sweeps of a Picard chain and
    the samples' largest |R^T R - I| and ||det R| - 1|."""
    device = resolve_device(args.device)
    model, process = build(args, device)
    model.eval()
    pairs = load_pairs(args)
    rng = np.random.default_rng(args.seed + 99)
    lr, ll = bucket_lengths(pairs)
    if not load_eval_weights(model, args.ckpt, device):
        print(f"warning: no checkpoint found at {args.ckpt}; evaluating untrained model")

    evals = [0]

    def denoise(x, t):
        evals[0] += 1
        return model(x, t)

    def sample(gen, proj, b):
        if args.sampler == "ddim":
            return process.ddim_sample_loop(denoise, gen, (b,), args.sampler_steps, proj), None
        if args.sampler == "pf":
            return process.pf_sample_loop(denoise, gen, (b,), args.sampler_steps, proj,
                                          method=args.pf_method), None
        if args.sampler == "picard":
            return process.parallel_sample_loop(denoise, gen, (b,), args.sampler_steps,
                                                projection=proj, return_sweeps=True)
        return process.p_sample_loop(denoise, gen, (b,), proj), None

    if args.batch > len(pairs):
        batch_indices = [rng.choice(len(pairs), size=args.batch, replace=True)]
    else:
        batch_indices = [np.arange(b, b + args.batch)
                         for b in range(0, len(pairs) - len(pairs) % args.batch, args.batch)]
    angles, shifts, sweeps = [], [], []
    orth = det = 0.0
    seconds, launches0, chains = 0.0, igso3_cuda.launches, 0
    for b, idx in enumerate(batch_indices):
        batch = to_device(pad_prot_batch(_augmented(pairs, idx, args, rng), lr, ll), device)
        proj = ProtProjection(batch)
        for s in range(SAMPLES):
            gen = torch.Generator(device=device)
            gen.manual_seed((args.seed + 1) * 1_000_003 + b * SAMPLES + s)
            _sync(device)
            t0 = time.perf_counter()
            aff, k = sample(gen, proj, args.batch)
            _sync(device)
            seconds += time.perf_counter() - t0
            chains += 1
            if k is not None:
                sweeps.append(k)
            eye = torch.eye(3, device=device)
            # nan_to_num: a non-finite sample reads as an infinite error, not as none
            orth = max(orth, float(torch.nan_to_num(
                (aff.rot.transpose(-1, -2) @ aff.rot - eye).abs(), nan=float("inf")).max()))
            det = max(det, float(torch.nan_to_num(
                (torch.linalg.det(aff.rot).abs() - 1.0).abs(), nan=float("inf")).max()))
            _, ang = rmat_to_aa(aff.rot)
            angles.append(ang[..., 0].cpu().numpy())
            shifts.append(torch.linalg.norm(aff.shift, dim=-1).cpu().numpy())
    angles, shifts = np.concatenate(angles), np.concatenate(shifts)
    diff_type = "se3" if args.sampler == "ancestral" else f"se3_{args.sampler}{args.sampler_steps}"
    print_percentiles(angles, shifts, diff_type)
    arm = os.path.basename(os.path.normpath(args.ckpt)) or diff_type
    if args.sampler != "ancestral":
        arm += f"_{args.sampler}{args.sampler_steps}"
    record = {
        "sampler": args.sampler, "sampler_steps": args.sampler_steps,
        "pf_method": args.pf_method if args.sampler == "pf" else None,
        "poses": int(len(angles)), "sample_seconds": seconds,
        "model_evals": evals[0] // max(chains, 1),
        "launches": igso3_cuda.launches - launches0, "sweeps": sweeps,
        "finite": bool(np.isfinite(angles).all() and np.isfinite(shifts).all()),
        "orth_err": orth, "det_err": det,
        "angles": angles.tolist(), "shifts": shifts.tolist(),
    }
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, f"torch_prot_samples_{arm}.json"), "w") as f:
        json.dump(record, f)
    return record


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Protein docking diffusion")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-4)
    add_optim_flags(p)
    p.add_argument("--dim", type=int, default=1024)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--t_depth", type=int, default=12)
    p.add_argument("--c_depth", type=int, default=8)
    p.add_argument("--se3", action="store_true")
    p.add_argument("--clip-shift", dest="clip_shift", type=float, default=75.0,
                   help="clamp the sampler's predicted x0 shift to +-this (0 = off, "
                        "reference parity: the reference sampler random-walks)")
    p.add_argument("--bf16", action="store_true",
                   help="run the residue conv, the encoder and the cross layers under "
                        "bf16 autocast")
    p.add_argument("--frame-pool", dest="frame_pool", action="store_true",
                   help="add gated frame-matrix pooling to the readout")
    p.add_argument("--cross-depth", dest="cross_depth", type=int, default=0,
                   help="receptor<->ligand cross-attention rounds after the encoder "
                        "(0 = reference parity)")
    p.add_argument("--conv-impl", dest="conv_impl", choices=CONV_IMPLS, default="xla_conv",
                   help="the JAX package's residue-conv lowering; all three compute the "
                        "same function here (one GEMM over three shifted copies)")
    p.add_argument("--rel-frame", dest="rel_frame", action="store_true",
                   help="append the bilinear relative-frame readout P_lig @ P_rec^T")
    p.add_argument("--equiv-head", dest="equiv_head", action="store_true",
                   help="receptor-frame-equivariant output head")
    p.add_argument("--timesteps", type=int, default=1000)
    p.add_argument("--steps", type=int, default=250_000, help="total batch steps")
    p.add_argument("--epoch-accum", dest="epoch_accum", action="store_true",
                   help="one optimizer step per epoch on the epoch's summed gradients "
                        "(the reference's loop)")
    p.add_argument("--steps-per-call", dest="steps_per_call", type=int, default=8,
                   help="optimizer steps per call of the step function (K distinct "
                        "batches; one CUDA graph replayed a step on the card); the "
                        "log has one row per call")
    p.add_argument("--log-norms-per-layer", dest="log_norms_per_layer", action="store_true",
                   help="log one grad norm per top-level module as grad_norm/<module>")
    p.add_argument("--no-augment", dest="no_augment", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data-root", dest="data_root", type=str, default="data/BPTI_dock")
    p.add_argument("--ckpt", type=str, default=None,
                   help="checkpoint directory (--test also takes a bare torch.save state "
                        "dict of ProtNet)")
    p.add_argument("--ckpt-every", dest="ckpt_every", type=int, default=10_000,
                   help="checkpoint save interval in steps")
    p.add_argument("--print-every", dest="print_every", type=int, default=10)
    p.add_argument("--log", type=str, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--debug-nans", dest="debug_nans", action="store_true",
                   help="enable torch.autograd.set_detect_anomaly")
    p.add_argument("--test", action="store_true")
    p.add_argument("--sampler", choices=("ancestral", "ddim", "pf", "picard"),
                   default="ancestral",
                   help="evaluation sampler: the 1000-step ancestral chain, DDIM, "
                        "probability flow, or Picard (parallel-in-time) DDIM")
    p.add_argument("--sampler-steps", dest="sampler_steps", type=int, default=50,
                   help="model evaluations for --sampler ddim/pf/picard")
    p.add_argument("--pf-method", dest="pf_method",
                   choices=("flow", "flow-state", "euler", "heun"), default="flow",
                   help="--sampler pf variant: 'flow' (prediction-anchored exact "
                        "transport) or the research variants (warned at run time)")
    p.add_argument("--out-dir", dest="out_dir", type=str, default="torch_results",
                   help="where --test writes torch_prot_samples_<arm>.json")
    p.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    args = p.parse_args(argv)
    if args.sampler == "pf" and args.pf_method != "flow":
        warnings.warn(
            f"--pf-method {args.pf_method} is a research variant with a MEASURED quality "
            "defect on SE(3) docking in the JAX package (flow-state: re-anchoring tail "
            "blowup, rot p99 3.14 / shift p99 33.6 on its 240k checkpoint; euler/heun: "
            "saturating-score under-transport, BENCHMARKS.md 'Probability-flow "
            "sampling'). Use --pf-method flow or --sampler ddim for production.",
            stacklevel=1,
        )
    if args.ckpt is None:
        args.ckpt = f"weights/protein_{'se3' if args.se3 else 'eul'}"
    return args


def main(argv=None):
    args = parse_args(argv)
    check_ported(args)
    with torch.autograd.set_detect_anomaly(args.debug_nans):
        return test(args) if args.test else train(args)


if __name__ == "__main__":
    main()
