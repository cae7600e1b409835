"""Bingham density matching, evaluation side (counterpart of
``diffusion_extensions_tpu/experiments/bingham.py``):

    python -m diffusion_extensions_tpu_torch.experiments.bingham lcr --test [--sampler-ab]

Draws SAMPLES target rotations from the preset's projected Gaussian and
SAMPLES model rotations from the 1000-step ancestral chain of
``SO3Diffusion`` through ``RotPredict(d_model=65, out_type="skewvec")``, and
reports MMD(model, target) with the Gaussian rotation kernel (whose three
block sums run the CUDA kernel on the card) against the reference's
acceptance threshold.  ``--sampler-ab`` adds the DDIM-50/20, PF flow-50/10,
PF Heun-25, PF Euler-50 and Picard DDIM-50 rows.

Weights are a ``torch.save`` state dict at ``--ckpt``
(``convert.rot_predict_params_from_flax`` makes one from a JAX checkpoint);
without one the seeded init is evaluated.  Records are printed as JSON lines
and written to ``--out-dir`` as ``torch_bingham_mmd_{cov}.json`` and
``torch_bingham_sampler_ab_{cov}.json``.  Each sampler is first run once
at the timed shape (NET_SAMPLES chains) outside the timer, as the reference
does: the first calls build the kernels, grow the caching allocator and set
up cuBLAS and cuSOLVER.  ``sample_seconds`` (unrounded) ends in a
synchronise.
Training lands with a later slice.
"""
from __future__ import annotations

import argparse
import copy
import json
import math
import os
import time

import torch

from .. import resolve_device
from ..data.synthetic import BINGHAM_COVS, bingham_dist
from ..models.rot_predict import RotPredict
from ..ops import igso3_cuda, mmd_cuda
from ..ops.metrics import gaussian_kernel_matrix, mmd
from ..ops.so3 import quat_to_rmat
from ..processes.so3 import SO3Diffusion

SAMPLES = 20_000  # bingham_test.py:7
NET_SAMPLES = 20_000
MMD_CHUNK = 4_000  # bingham_test.py:29
OUT_DIR = "torch_results"


def build(args, device):
    """(model, process); the model's init is seeded by ``args.seed``."""
    torch.manual_seed(args.seed)
    model = RotPredict(d_model=65, out_type="skewvec").to(device).eval()
    process = SO3Diffusion.create(args.timesteps, device=device)
    return model, process


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
    return {"igso3_logpdf_score": igso3_cuda.launches,
            "gaussian_kernel_sum": mmd_cuda.launches}


@torch.inference_mode()
def test(args) -> list[dict]:
    """The ancestral row (and with ``args.sampler_ab`` the A/B rows); one
    record per row."""
    device = resolve_device(args.device)
    model, process = build(args, device)
    if os.path.isfile(args.ckpt):
        model.load_state_dict(torch.load(args.ckpt, map_location=device))
    else:
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
    p = argparse.ArgumentParser(description="Bingham density matching (evaluation)")
    p.add_argument("cov", choices=sorted(BINGHAM_COVS) + ["all"],
                   help="covariance preset, or 'all' for the 4 presets")
    p.add_argument("--timesteps", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt", type=str, default=None,
                   help="torch.save state dict of RotPredict "
                        "(default weights/bingham_{cov}.pt)")
    p.add_argument("--test", action="store_true")
    p.add_argument("--sampler-ab", dest="sampler_ab", action="store_true",
                   help="with --test: also the DDIM-50/20, PF flow-50/10, "
                        "PF Heun-25, PF Euler-50 and Picard DDIM-50 rows")
    p.add_argument("--out-dir", dest="out_dir", type=str, default=OUT_DIR,
                   help="directory for the torch_bingham_*.json records")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda)")
    return p.parse_args(argv)


def main(argv=None) -> dict[str, list[dict]]:
    args = parse_args(argv)
    if not args.test:
        raise SystemExit("training lands with a later slice of the port; pass --test")
    covs = sorted(BINGHAM_COVS) if args.cov == "all" else [args.cov]
    results = {}
    for cov in covs:
        a = copy.copy(args)
        a.cov = cov
        if args.cov == "all" or a.ckpt is None:
            a.ckpt = f"weights/bingham_{cov}.pt"
        results[cov] = test(a)
    return results


if __name__ == "__main__":
    main()
