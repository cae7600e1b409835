"""MLP rotation denoisers of the toy, lock and Bingham experiments
(counterpart of ``diffusion_extensions_tpu/models/rot_predict.py``)."""
from __future__ import annotations

import torch
from torch import nn

from ..ops.so3 import six2rmat
from .layers import ResMLPBlock, SinusoidalPosEmb, dense

__all__ = ["RotPredict", "EulerRotPredict"]


class RotPredict(nn.Module):
    """Rotation-matrix-input denoiser: the flattened rotation (9) and a
    sinusoidal embedding of t (d_model - 9), then

    * ``variant="mlp"``: 4 Linear + SiLU layers of width d_model (the
      Bingham and toy model, d_model 65);
    * ``variant="resnet"``: 6 residual Linear + SiLU blocks (the lock
      model, d_model 255);

    and a Linear head.  ``out_type``: "skewvec" gives a (B, 3) tangent
    vector, "rotmat" a 6D output mapped to a rotation by Gram-Schmidt.
    """

    def __init__(self, d_model: int = 65, out_type: str = "skewvec", variant: str = "mlp"):
        super().__init__()
        if out_type not in ("skewvec", "rotmat"):
            raise ValueError(f"Unexpected out_type: {out_type}")
        if variant == "mlp":
            blocks = [dense(d_model, d_model) for _ in range(4)]
        elif variant == "resnet":
            blocks = [ResMLPBlock(d_model) for _ in range(6)]
        else:
            raise ValueError(f"Unexpected variant: {variant}")
        self.out_type = out_type
        self.variant = variant
        self.t_emb = SinusoidalPosEmb(d_model - 9)
        self.hidden = nn.ModuleList(blocks)
        self.out = dense(d_model, 3 if out_type == "skewvec" else 6)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        x_flat = x.reshape(*x.shape[:-2], 9)
        t_emb = self.t_emb(t)
        if t_emb.shape[0] == 1:
            t_emb = t_emb.expand(x_flat.shape[0], t_emb.shape[-1])
        h = torch.cat((x_flat, t_emb), dim=-1)
        for block in self.hidden:
            h = nn.functional.silu(block(h)) if self.variant == "mlp" else block(h)
        out = self.out(h)
        return six2rmat(out) if self.out_type == "rotmat" else out


class EulerRotPredict(nn.Module):
    """Euler-angle-input baseline of the lock ablation: the angles (3) and
    a sinusoidal embedding of t (d_model - 3), 6 residual Linear + SiLU
    blocks, a Linear head to (B, 3).  Its modules are named as
    ``RotPredict(variant="resnet", out_type="skewvec")``'s, whose weights
    have the same shapes at the same d_model."""

    def __init__(self, d_model: int = 255):
        super().__init__()
        self.t_emb = SinusoidalPosEmb(d_model - 3)
        self.hidden = nn.ModuleList(ResMLPBlock(d_model) for _ in range(6))
        self.out = dense(d_model, 3)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        t_emb = self.t_emb(t)
        if t_emb.shape[0] == 1:
            t_emb = t_emb.expand(x.shape[0], t_emb.shape[-1])
        h = torch.cat((x, t_emb), dim=-1)
        for block in self.hidden:
            h = block(h)
        return self.out(h)
