"""Bingham density matching (counterpart of
``diffusion_extensions_tpu/experiments/bingham.py``): train SO(3) diffusion
on projected-Gaussian quaternion samples, evaluate sample fidelity by MMD.

    python -m diffusion_extensions_tpu_torch.experiments.bingham lcr --steps 100000
    python -m diffusion_extensions_tpu_torch.experiments.bingham lcr --test [--sampler-ab]

Training draws ``--batch`` target rotations a step from the preset's
projected Gaussian (``--steps-per-call`` steps' worth per draw), takes the
skew-vec loss of ``SO3Diffusion`` through
``RotPredict(d_model=65, out_type="skewvec")`` and applies Adam.  Every
``--mmd-every`` steps (and at ``--steps``) it draws NET_SAMPLES rotations
from the 1000-step ancestral chain of the current weights and records
MMD(model, target): the online MMD curve, written to
``--out-dir/torch_bingham_mmd_curve_{cov}.json``.  Checkpoints go to the
directory ``--ckpt`` (default ``weights/bingham_{cov}``).  ``all`` trains
and then tests each of the four presets.

``--test`` draws SAMPLES target rotations and SAMPLES model rotations from
the ancestral chain, and reports MMD(model, target) with the Gaussian
rotation kernel (whose three block sums run the CUDA kernel on the card)
against the reference's acceptance threshold.  ``--sampler-ab`` adds the
DDIM-50/20, PF flow-50/10, PF Heun-25, PF Euler-50 and Picard DDIM-50 rows.
Its weights are the newest checkpoint of the directory ``--ckpt`` (or a bare
``torch.save`` state dict of RotPredict at that path, which
``convert.rot_predict_params_from_flax`` makes from a JAX checkpoint);
without either the seeded init is evaluated.  Records are printed as JSON
lines and written to ``--out-dir`` as ``torch_bingham_mmd_{cov}.json`` and
``torch_bingham_sampler_ab_{cov}.json``.  Each sampler is first run once
at the timed shape (NET_SAMPLES chains) outside the timer, as the reference
does: the first calls build the kernels, grow the caching allocator and set
up cuBLAS and cuSOLVER.  ``sample_seconds`` (unrounded) ends in a
synchronise.
"""
from __future__ import annotations

import argparse
import copy
import json
import math
import os
import time

import torch

from .. import obs, resolve_device
from ..data.synthetic import BINGHAM_COVS, bingham_dist
from ..models.rot_predict import RotPredict
from ..ops.metrics import gaussian_kernel_matrix, mmd
from ..ops.so3 import quat_to_rmat
from ..parallel.dp import make_dp_train_step
from ..processes.so3 import SO3Diffusion
from ..train.loop import MetricLogger, Throughput
from ..train.optim import make_optimizer
from ..train.state import (
    TrainState,
    load_eval_weights,
    restore_checkpoint,
    save_checkpoint,
)

SAMPLES = 20_000  # bingham_test.py:7
NET_SAMPLES = 20_000
MMD_CHUNK = 4_000  # bingham_test.py:29
OUT_DIR = "torch_results"


def build(args, device):
    """(model, process); the model's init is seeded by ``args.seed``."""
    torch.manual_seed(args.seed)
    model = RotPredict(d_model=65, out_type="skewvec").to(device)
    process = SO3Diffusion.create(args.timesteps, loss_type="skewvec", device=device)
    return model, process



def _make_mmd_eval(model, process, dist, args, device):
    """Online MMD evaluation: ``eval_mmd(step)`` draws NET_SAMPLES rotations
    from the ancestral chain of the current weights and returns (MMD against
    SAMPLES target rotations, seconds); on the card the MMD is three
    launches of the ``gaussian_kernel_sum`` kernel."""
    gen = torch.Generator(device=device).manual_seed(args.seed + 2)
    bing_samples = quat_to_rmat(dist.sample(gen, (SAMPLES,)))
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def eval_mmd(step: int) -> tuple[float, float]:
        chain_gen = torch.Generator(device=device).manual_seed(
            (args.seed + 3) * 1_000_003 + step)
        t0 = time.perf_counter()
        with torch.no_grad():
            diff_samples = process.p_sample_loop(model, chain_gen, (NET_SAMPLES,))
            val = float(mmd(bing_samples, diff_samples, gaussian_kernel_matrix,
                            chunksize=MMD_CHUNK))
        sync()
        return val, time.perf_counter() - t0

    return eval_mmd


def due(i: int, every: int, k: int, steps: int) -> bool:
    """Whether the call that took the step counter to ``i`` by ``k`` steps
    passed a multiple of ``every``, or reached ``steps``."""
    return i % every < k or i >= steps


def train(args):
    """Returns (state, the MMD curve as a list of {"step", "mmd", "seconds"})."""
    device = resolve_device(args.device)
    model, process = build(args, device)
    dist = bingham_dist(args.cov, device)
    optimizer = make_optimizer(model.named_parameters(), args.lr)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    state = TrainState(model, optimizer, generator)
    if args.resume:
        state = restore_checkpoint(args.ckpt, state)

    def loss_fn(gen, batch):
        return process.loss(model, gen, batch)

    K = max(min(args.steps_per_call, args.steps), 1)
    step_fn = make_dp_train_step(loss_fn, model, optimizer, steps_per_call=K)
    data_gen = torch.Generator(device=device).manual_seed(args.seed + 1)

    def make_batch(k: int) -> torch.Tensor:
        rots = quat_to_rmat(dist.sample(data_gen, (k * args.batch,)))
        return rots.reshape(k, args.batch, 3, 3) if K > 1 else rots

    eval_mmd = _make_mmd_eval(model, process, dist, args, device) if args.mmd_every else None
    mmd_curve = []

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
            if i % args.print_every < k:
                logger.log(i, {"loss": float(metrics["loss"]),
                               "steps_per_sec": meter.steps_per_sec or float("nan")})
            if due(i, args.ckpt_every, k, args.steps):
                save_checkpoint(args.ckpt, state, step=i)
            if eval_mmd is not None and due(i, args.mmd_every, k, args.steps):
                val, seconds = eval_mmd(i)
                mmd_curve.append({"step": i, "mmd": val, "seconds": seconds})
                print(json.dumps({"cov": args.cov, "step": i, "mmd": val,
                                  "seconds": seconds}), flush=True)
    finally:
        logger.close()
    if mmd_curve:
        os.makedirs(args.out_dir, exist_ok=True)
        with open(os.path.join(args.out_dir, f"torch_bingham_mmd_curve_{args.cov}.json"),
                  "w") as f:
            json.dump(mmd_curve, f)
    return state, mmd_curve


def sampler_rows(process, sampler_ab: bool):
    """(tag, sample(denoise_fn, generator, n) -> (rotations, sweeps or None))."""
    def plain(loop, **kw):
        return lambda f, g, n: (loop(f, g, (n,), **kw), None)

    rows = [("ancestral_1000", plain(process.p_sample_loop))]
    if sampler_ab:
        rows += [
            ("ddim_50", plain(process.ddim_sample_loop, num_steps=50)),
            ("ddim_20", plain(process.ddim_sample_loop, num_steps=20)),
            ("pf_flow_50", plain(process.pf_sample_loop, num_steps=50)),
            ("pf_flow_10", plain(process.pf_sample_loop, num_steps=10)),
            ("pf_heun_25_karras", plain(process.pf_sample_loop, num_steps=25,
                                        method="heun", grid="karras")),
            ("pf_euler_50_karras", plain(process.pf_sample_loop, num_steps=50,
                                         method="euler", grid="karras")),
            ("ddim_50_picard", lambda f, g, n: process.parallel_sample_loop(
                f, g, (n,), num_steps=50, tol=1e-4, return_sweeps=True)),
        ]
    return rows


def rotation_errors(r: torch.Tensor) -> dict:
    """max |R^T R - I| and max ||det R| - 1| over the samples."""
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    return {
        "orth_err": float((r.transpose(-1, -2) @ r - eye).abs().max()),
        "det_err": float((torch.linalg.det(r).abs() - 1.0).abs().max()),
    }


def _launches() -> dict:
    return {"igso3_logpdf_score": obs.counter("ops.igso3.launches"),
            "gaussian_kernel_sum": obs.counter("ops.mmd.launches")}


@torch.inference_mode()
def test(args) -> list[dict]:
    """The ancestral row (and with ``args.sampler_ab`` the A/B rows); one
    record per row."""
    device = resolve_device(args.device)
    model, process = build(args, device)
    model.eval()
    if not load_eval_weights(model, args.ckpt, device):
        print(f"warning: no checkpoint found at {args.ckpt}; evaluating untrained model")
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    dist = bingham_dist(args.cov, device)
    gen = torch.Generator(device=device).manual_seed(args.seed + 2)
    bing_samples = quat_to_rmat(dist.sample(gen, (SAMPLES,)))
    # reference acceptance threshold (util.py:289-299), alpha = 0.05
    accept = (2.0 / SAMPLES) ** 0.5 * (1 + (2 * math.log(1 / 0.05)) ** 0.5)
    os.makedirs(args.out_dir, exist_ok=True)

    evals = 0

    def denoise(x, t):
        nonlocal evals
        evals += 1
        return model(x, t)

    def chain_gen(i: int) -> torch.Generator:
        return torch.Generator(device=device).manual_seed((args.seed + 3) * 1_000_003 + i)

    records = []
    for tag, sample in sampler_rows(process, args.sampler_ab):
        sample(denoise, chain_gen(-1), NET_SAMPLES)
        sync()
        evals, before = 0, _launches()
        chunks, sweeps = [], None
        t0 = time.perf_counter()
        for i in range(SAMPLES // NET_SAMPLES):
            rots, sweeps = sample(denoise, chain_gen(i), NET_SAMPLES)
            chunks.append(rots)
        sync()
        dt = time.perf_counter() - t0
        model_evals = evals
        diff_samples = torch.cat(chunks, dim=0)
        val = float(mmd(bing_samples, diff_samples, gaussian_kernel_matrix,
                        chunksize=MMD_CHUNK))
        after = _launches()
        rec = {"cov": args.cov, "sampler": tag, "mmd": val, "count": SAMPLES,
               "accept_threshold": accept, "passes": val < accept,
               "sample_seconds": dt, "model_evals": model_evals,
               "launches": {k: after[k] - before[k] for k in after},
               **rotation_errors(diff_samples)}
        if sweeps is not None:
            rec["sweeps"] = sweeps
        print(json.dumps(rec), flush=True)
        records.append(rec)

    with open(os.path.join(args.out_dir, f"torch_bingham_mmd_{args.cov}.json"), "w") as f:
        json.dump(records[0], f)
    if args.sampler_ab:
        with open(os.path.join(args.out_dir, f"torch_bingham_sampler_ab_{args.cov}.json"),
                  "w") as f:
            json.dump(records, f)
    return records


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Bingham density matching")
    p.add_argument("cov", choices=sorted(BINGHAM_COVS) + ["all"],
                   help="covariance preset, or 'all' for the 4 presets")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--steps", type=int, default=100_000)
    p.add_argument("--steps-per-call", dest="steps_per_call", type=int,
                   default=16, help="run K optimizer steps per call of the step function")
    p.add_argument("--mmd-every", dest="mmd_every", type=int, default=10_000,
                   help="online MMD(model, target) eval interval (0 disables)")
    p.add_argument("--timesteps", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt", type=str, default=None,
                   help="checkpoint directory, default weights/bingham_{cov} "
                        "(--test also takes a bare torch.save state dict of "
                        "RotPredict)")
    p.add_argument("--ckpt-every", dest="ckpt_every", type=int, default=1000)
    p.add_argument("--print-every", dest="print_every", type=int, default=10)
    p.add_argument("--log", type=str, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--debug-nans", dest="debug_nans", action="store_true",
                   help="enable torch.autograd.set_detect_anomaly")
    p.add_argument("--test", action="store_true")
    p.add_argument("--sampler-ab", dest="sampler_ab", action="store_true",
                   help="with --test: also the DDIM-50/20, PF flow-50/10, "
                        "PF Heun-25, PF Euler-50 and Picard DDIM-50 rows")
    p.add_argument("--out-dir", dest="out_dir", type=str, default=OUT_DIR,
                   help="directory for the torch_bingham_*.json records")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)
    if args.ckpt is None and args.cov != "all":
        args.ckpt = f"weights/bingham_{args.cov}"
    return args


def main(argv=None) -> dict[str, list[dict]]:
    """Per preset: the ``test()`` records, or after training alone the MMD
    curve."""
    args = parse_args(argv)
    covs = sorted(BINGHAM_COVS) if args.cov == "all" else [args.cov]
    results = {}
    with torch.autograd.set_detect_anomaly(args.debug_nans):
        for cov in covs:
            a = copy.copy(args)
            a.cov = cov
            if args.cov == "all":
                a.ckpt = f"weights/bingham_{cov}"
            if a.test:
                results[cov] = test(a)
            else:
                results[cov] = train(a)[1]
                if args.cov == "all":  # the full matrix: the final SAMPLES-sample MMD too
                    results[cov] = test(a)
    return results


if __name__ == "__main__":
    main()
