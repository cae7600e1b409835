"""SE(3) containers and group ops (counterpart of
``diffusion_extensions_tpu/ops/se3.py``).

``AffineT`` is an SE(3) element (rotation (..., 3, 3), shift (..., 3)),
``AffineGrad`` a tangent vector (rot_g (..., 3), shift_g (..., 3)), the SE(3)
denoisers' output.  Both are plain containers of tensors; ``ProtData`` is a
NamedTuple (one-hot residues, C-alpha positions, local frames).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .so3 import euler_to_rmat, rmul, so3_lerp, so3_scale

__all__ = ["AffineT", "AffineGrad", "ProtData", "se3_lerp", "se3_scale"]


class AffineT:
    """SE(3) element: ``rot`` (..., 3, 3) and ``shift`` (..., 3)."""

    __slots__ = ("rot", "shift")

    def __init__(self, rot: torch.Tensor, shift: torch.Tensor):
        self.rot = rot
        self.shift = shift

    def __len__(self):
        return max(len(self.rot), len(self.shift))

    def __getitem__(self, item):
        return AffineT(self.rot[item], self.shift[item])

    @property
    def shape(self):
        return self.shift.shape

    @property
    def dtype(self):
        return self.shift.dtype

    @classmethod
    def identity(cls, batch_shape=(), dtype=torch.float32, device=None) -> "AffineT":
        rot = torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3)
        shift = torch.zeros((*batch_shape, 3), dtype=dtype, device=device)
        return cls(rot, shift)

    @classmethod
    def from_euler(cls, euls: torch.Tensor, shift: torch.Tensor) -> "AffineT":
        """Rotation from XYZ Euler angles ``euls`` (..., 3), and ``shift``."""
        return cls(euler_to_rmat(euls[..., 0], euls[..., 1], euls[..., 2]), shift)

    def compose(self, other: "AffineT") -> "AffineT":
        """(R1, s1) . (R2, s2) = (R1 R2, R1 s2 + s1)."""
        shift = torch.matmul(self.rot, other.shift[..., None])[..., 0] + self.shift
        return AffineT(rmul(self.rot, other.rot), shift)

    def __repr__(self):
        return f"AffineT(rot={tuple(self.rot.shape)}, shift={tuple(self.shift.shape)})"


class AffineGrad:
    """Tangent-space vector: ``rot_g`` (..., 3) skew-vec and ``shift_g``
    (..., 3)."""

    __slots__ = ("rot_g", "shift_g")

    def __init__(self, rot_g: torch.Tensor, shift_g: torch.Tensor):
        self.rot_g = rot_g
        self.shift_g = shift_g

    def __len__(self):
        return max(len(self.rot_g), len(self.shift_g))

    def __getitem__(self, item):
        return AffineGrad(self.rot_g[item], self.shift_g[item])

    def __repr__(self):
        return f"AffineGrad(rot_g={tuple(self.rot_g.shape)}, shift_g={tuple(self.shift_g.shape)})"


class ProtData(NamedTuple):
    """Protein rigid gas: one-hot residues (N, 21), C-alpha positions
    (N, 3), local frames (N, 3, 3); numpy arrays on the host, tensors on
    the device, with leading batch dims when batched."""

    residues: torch.Tensor
    positions: torch.Tensor
    angles: torch.Tensor


def se3_lerp(transf_a: AffineT, transf_b: AffineT, weight: torch.Tensor) -> AffineT:
    """Geodesic interpolation of the rotation, linear of the shift;
    ``weight`` carries a trailing singleton dim, as ``so3_lerp``'s does."""
    rot = so3_lerp(transf_a.rot, transf_b.rot, weight)
    shift = transf_a.shift + weight * (transf_b.shift - transf_a.shift)
    return AffineT(rot, shift)


def se3_scale(transf: AffineT, scalars: torch.Tensor) -> AffineT:
    """Fractional power of the rotation, scaled shift."""
    return AffineT(so3_scale(transf.rot, scalars), transf.shift * scalars[..., None])
