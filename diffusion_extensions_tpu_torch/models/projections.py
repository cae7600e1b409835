"""Projection operators (counterpart of
``diffusion_extensions_tpu/models/projections.py``): render the diffusion
state onto the data before the denoiser sees it."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.se3 import AffineT, ProtData
from ..ops.so3 import euler_to_rmat

__all__ = ["PointCloudProj", "ProtBatch", "move_prot_batch", "ProtProjection"]


def _euler_rot(x: torch.Tensor) -> torch.Tensor:
    return euler_to_rmat(x[..., 0], x[..., 1], x[..., 2])


class PointCloudProj:
    """``data @ R^T``: every point of each cloud rotated by the state's R.
    ``so3=False`` (the Euler arm): the state is (B, 3) XYZ Euler angles,
    decoded to R first."""

    def __init__(self, data: torch.Tensor, so3: bool = True):
        self.data = data  # (B, N, 3)
        self.so3 = so3

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        r = x if self.so3 else _euler_rot(x)
        return torch.matmul(self.data, r.transpose(-1, -2))


class ProtBatch(NamedTuple):
    """Padded receptor/ligand pairs with validity masks (True = a residue):
    ``receptor`` and ``ligand`` are ProtData with fields (B, L, ...), the
    masks (B, Lr) and (B, Ll) bool."""

    receptor: ProtData
    ligand: ProtData
    receptor_mask: torch.Tensor
    ligand_mask: torch.Tensor


def move_prot_batch(transf: AffineT, prot: ProtData, mask: torch.Tensor) -> ProtData:
    """Apply one rigid transform per batch row about that protein's masked
    centroid: positions (p - c) R^T + c + s, frames F R^T."""
    m = mask[..., None].to(prot.positions.dtype)
    denom = torch.clamp(torch.sum(m, dim=-2, keepdim=True), min=1.0)
    mean_pos = torch.sum(prot.positions * m, dim=-2, keepdim=True) / denom
    rot_t = transf.rot.transpose(-1, -2)  # (B, 3, 3)
    pos = torch.matmul(prot.positions - mean_pos, rot_t) + mean_pos + transf.shift[..., None, :]
    angles = torch.matmul(prot.angles, rot_t[..., None, :, :])
    return ProtData(prot.residues, pos, angles)


def _tile(x, k: int):
    """k copies of every leaf along the batch axis, copy-major."""
    if isinstance(x, tuple):
        return type(x)(*(_tile(v, k) for v in x))
    return x.repeat(k, *([1] * (x.dim() - 1)))


class ProtProjection:
    """Move the ligand by the current transform, keep the receptor.

    The transforms' leading size may be k times the batch's (k >= 1): the
    Picard sampler evaluates every grid point of a sweep in one call, its
    row s * B + j being protein j at grid point s.  The batch is then tiled
    k times in that order (the JAX package's ``ProtProjection`` holds only
    the B proteins and fails on such a call).  ``se3=False`` (the Euler
    arm): the state is (B, 6), XYZ Euler angles then the shift, decoded to
    an AffineT first."""

    def __init__(self, batch: ProtBatch, se3: bool = True):
        self.batch = batch
        self.se3 = se3

    def __call__(self, transforms) -> ProtBatch:
        if not self.se3:
            transforms = AffineT(_euler_rot(transforms[..., :3]), transforms[..., 3:])
        batch = self.batch
        b, n = batch.receptor_mask.shape[0], transforms.shift.shape[0]
        if n != b:
            if n % b:
                raise ValueError(f"{n} transforms for a batch of {b} proteins")
            batch = _tile(batch, n // b)
        new_lig = move_prot_batch(transforms, batch.ligand, batch.ligand_mask)
        return ProtBatch(batch.receptor, new_lig, batch.receptor_mask, batch.ligand_mask)
