"""Per-block probe of a trained protein docking checkpoint (counterpart of
the JAX package's ``tools/probe_protein.py``):

    python -m diffusion_extensions_tpu_torch.experiments.probe_protein --ckpt weights/protein_se3
    python -m diffusion_extensions_tpu_torch.experiments.probe_protein --ckpt <dir> \\
        --frame-pool --cross-depth 2 --rel-frame --equiv-head

At t in {20, 100, 300, 600, 900} it measures the denoiser's rotation-block
and shift-block MSE against its targets (the scaled log of the rotation
noise, the scaled shift noise) beside the zero predictor's: which block of
the docking transform the model has learned.  Each t averages ``--rounds``
draws of the noise over a batch of ``--batch`` of the 16 synthetic pairs
from ``default_rng(0)`` (``--augment``: each pair moved by a fresh Haar
SE(3) transform a round, the reference's augmentation).  The weights are
the newest checkpoint of the directory ``--ckpt``, restored
``params_only`` (an empty directory leaves the seeded init, as the JAX
tool does).  ``probe_terms`` is one t's computation from explicit noise.
Runs on the card unless ``--device`` says otherwise.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import resolve_device
from ..data.pdb import (
    move_prots_np,
    pad_prot_batch,
    random_affine_np,
    synthetic_prot_pair,
    to_device,
)
from ..models.projections import ProtProjection
from ..models.protnet import ProtNet
from ..ops.se3 import AffineT
from ..ops.so3 import log_rmat_vec
from ..processes.schedule import extract
from ..processes.se3 import ProjectedSE3Diffusion
from ..train.state import TrainState, restore_checkpoint

TIMESTEPS = (20, 100, 300, 600, 900)


def probe_terms(model, process, batch, t: torch.Tensor, noise: AffineT) -> torch.Tensor:
    """(rotation MSE of the model, of the zero predictor, shift MSE of the
    model, of the zero predictor) at timesteps ``t`` (B,) for the identity
    pose noised by ``noise``: the targets are log(noise.rot) / eps_t and
    noise.shift / (eps_t shift_scale)."""
    b = t.shape[0]
    eps = extract(process.schedule.sqrt_one_minus_alphas_cumprod, t, 1)
    x_noisy = process.q_sample(AffineT.identity((b,), device=t.device), t, noise)
    pred = model(ProtProjection(batch, se3=True)(x_noisy), t)
    tgt_rot = log_rmat_vec(noise.rot) / eps
    tgt_shift = noise.shift / (eps * process.shift_scale)

    def mse(a, b):
        return torch.mean((a - b) ** 2)

    return torch.stack((mse(pred.rot_g, tgt_rot), mse(0.0 * tgt_rot, tgt_rot),
                        mse(pred.shift_g, tgt_shift), mse(0.0 * tgt_shift, tgt_shift)))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Per-block probe of a protein checkpoint")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--dim", type=int, default=1024)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--t_depth", type=int, default=12)
    p.add_argument("--c_depth", type=int, default=8)
    p.add_argument("--frame-pool", dest="frame_pool", action="store_true")
    p.add_argument("--cross-depth", dest="cross_depth", type=int, default=0)
    p.add_argument("--rel-frame", dest="rel_frame", action="store_true")
    p.add_argument("--equiv-head", dest="equiv_head", action="store_true")
    p.add_argument("--augment", action="store_true",
                   help="probe under the reference's Haar SE(3) augmentation "
                        "(prot_train.py:95-100) instead of canonical poses")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--rounds", type=int, default=8)
    p.add_argument("--timesteps", type=int, default=1000)
    p.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    return p.parse_args(argv)


@torch.inference_mode()
def main(argv=None) -> np.ndarray:
    """Prints one line a t and returns the (len(TIMESTEPS), 4) means."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    B = args.batch
    rng = np.random.default_rng(0)
    pairs = [synthetic_prot_pair(rng) for _ in range(16)]
    lr = max(q[0].positions.shape[0] for q in pairs)
    ll = max(q[1].positions.shape[0] for q in pairs)

    def collate(round_idx: int):
        chosen = []
        for i in range(B):
            rec, lig = pairs[(i + round_idx) % 16]
            if args.augment:
                rot, shift = random_affine_np(rng)
                rec, lig = move_prots_np(rot, shift, (rec, lig))
            chosen.append((rec, lig))
        return to_device(pad_prot_batch(chosen, lr, ll), device)

    batch = collate(0)
    torch.manual_seed(0)
    with torch.device(device):
        model = ProtNet(dim=args.dim, heads=args.heads, t_depth=args.t_depth,
                        c_depth=args.c_depth, se3=True, frame_pool=args.frame_pool,
                        cross_depth=args.cross_depth, rel_frame=args.rel_frame,
                        equiv_head=args.equiv_head)
    model.eval()
    process = ProjectedSE3Diffusion(timesteps=args.timesteps, device=device)
    state = restore_checkpoint(args.ckpt, TrainState(model, None, torch.Generator(device=device)),
                               params_only=True)
    print(f"ckpt step: {state.step}")

    table = np.zeros((len(TIMESTEPS), 4))
    for row, t_s in enumerate(TIMESTEPS):
        t = torch.full((B,), t_s, dtype=torch.long, device=device)
        for r in range(args.rounds):
            gen = torch.Generator(device=device).manual_seed(42_000 + t_s * 10 + r)
            rb = collate(r) if args.augment else batch
            table[row] += probe_terms(model, process, rb, t,
                                      process.sample_noise(gen, t)).cpu().numpy()
        table[row] /= args.rounds
        m = table[row]
        print(f"t={t_s:4d}  rot: model {m[0]:.4f} vs zero {m[1]:.4f} | "
              f"shift: model {m[2]:.4f} vs zero {m[3]:.4f}", flush=True)
    return table


if __name__ == "__main__":
    main()
