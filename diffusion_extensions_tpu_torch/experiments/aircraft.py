"""Aircraft rotational alignment, evaluation side (counterpart of
``diffusion_extensions_tpu/experiments/aircraft.py``):

    python -m diffusion_extensions_tpu_torch.experiments.aircraft --so3 --test

Samples SAMPLES_PER_SHAPE rotations per test shape with the ancestral chain
of ``ProjectedSO3Diffusion`` through ``PlaneNet`` and prints the angle-error
percentile table.  Weights are a ``torch.save`` state dict at ``--ckpt``
(``convert.planenet_params_from_flax`` makes one from a JAX checkpoint);
without one the seeded init is evaluated.  Falls back to ``synthetic_planes``
when the ShapeNet files are absent.  Training lands with a later slice.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import resolve_device
from ..data.shapenet import ShapeNet, synthetic_planes
from ..models.planenet import PlaneNet
from ..models.projections import PointCloudProj
from ..ops.so3 import rmat_to_aa
from ..processes.so3 import ProjectedSO3Diffusion

SAMPLES_PER_SHAPE = 8
PERCENTILES = (1, 5, 10, 50, 90, 95, 99)


def load_data(split: str, args) -> np.ndarray:
    try:
        return ShapeNet(split, (0,), root=args.data_root).data
    except (FileNotFoundError, OSError):
        n = 1024 if split == "train" else 128
        seed = {"train": 0, "valid": 1, "test": 2}[split]
        print(f"ShapeNet not found under {args.data_root}; "
              f"using synthetic_planes({n}) for split={split}")
        return synthetic_planes(n, seed=seed)


def subsample_points(clouds: np.ndarray, samples: int, seed: int) -> np.ndarray:
    """Random per-shape point subsample (not a head slice: the synthetic
    generator fills parts in order, so a head slice is the fuselage only)."""
    if clouds.shape[1] <= samples:
        return clouds
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, clouds.shape[1], size=(len(clouds), samples))
    return np.take_along_axis(clouds, cols[..., None], axis=1)


def build(args, device):
    """(model, process); the model's init is seeded by ``args.seed``."""
    if not args.so3:
        raise SystemExit(
            "the Euler arm (processes/r3.py) is not ported yet; pass --so3"
        )
    torch.manual_seed(args.seed)
    model = PlaneNet(dim=args.dim, heads=args.heads, layers=args.layers, bf16=args.bf16)
    model = model.to(device).eval()
    process = ProjectedSO3Diffusion(timesteps=args.timesteps, device=device)
    return model, process


def print_percentiles(res: np.ndarray, diff_type: str) -> None:
    res_sorted = np.sort(res)
    idxs = [int(len(res_sorted) * p / 100) for p in PERCENTILES]
    print(f"{len(res)} samples ({diff_type}); angle-error percentiles (rad):")
    print("percentiles " + " ".join(f"& {p}%" for p in PERCENTILES) + r" \\")
    print(diff_type + " " + " ".join(f"& {res_sorted[i]:.2f}" for i in idxs) + r" \\")


@torch.inference_mode()
def test(args):
    """Per-shape SAMPLES_PER_SHAPE-sample angle-error percentile table."""
    device = resolve_device(args.device)
    model, process = build(args, device)
    if os.path.isfile(args.ckpt):
        model.load_state_dict(torch.load(args.ckpt, map_location=device))
    else:
        print(f"warning: no checkpoint found at {args.ckpt}; evaluating untrained model")

    test_data = subsample_points(load_data("test", args), args.samples, args.seed + 17)
    results = []
    for b in range(0, len(test_data), args.batch):
        batch_np = test_data[b : b + args.batch]
        n_valid = len(batch_np)
        if n_valid < args.batch:
            # pad the ragged tail to the full batch shape
            pad = np.repeat(batch_np[-1:], args.batch - n_valid, axis=0)
            batch_np = np.concatenate([batch_np, pad], axis=0)
        proj = PointCloudProj(torch.from_numpy(batch_np).to(device))
        for s in range(SAMPLES_PER_SHAPE):
            gen = torch.Generator(device=device)
            gen.manual_seed((args.seed + 1) * 1_000_003 + b * 100 + s)
            rots = process.p_sample_loop(model, gen, (args.batch,), proj)
            _, angle = rmat_to_aa(rots)
            results.append(angle[:n_valid, 0].cpu().numpy())
        if args.max_shapes and b + args.batch >= args.max_shapes:
            break

    res = np.concatenate(results)
    out_dir = os.path.dirname(args.ckpt) or "."
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "results_aircraft_so3.npy"), res)
    print_percentiles(res, "so3")
    return res


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Aircraft rotation args")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--samples", type=int, default=256)
    p.add_argument("--dim", type=int, default=512)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--so3", action="store_true")
    p.add_argument("--bf16", action="store_true",
                   help="run the transformer encoder under bf16 autocast")
    p.add_argument("--timesteps", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data-root", dest="data_root", type=str,
                   default="data/shapenetcorev2_hdf5_2048")
    p.add_argument("--ckpt", type=str, default=None,
                   help="torch.save state dict of PlaneNet")
    p.add_argument("--test", action="store_true")
    p.add_argument("--max-shapes", dest="max_shapes", type=int, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)
    if args.ckpt is None:
        args.ckpt = f"weights/aircraft_{'so3' if args.so3 else 'eul'}.pt"
    return args


def main(argv=None):
    args = parse_args(argv)
    if not args.test:
        raise SystemExit("training lands with a later slice of the port; pass --test")
    return test(args)


if __name__ == "__main__":
    main()
