"""Point-cloud denoiser of the aircraft alignment experiment (counterpart of
``diffusion_extensions_tpu/models/planenet.py``, ``PlaneNet`` only).

Siren point embedding + sinusoidal timestep embedding, a post-norm
transformer encoder over the points, gated pooling and a linear head.
``bf16=True`` runs the encoder under bf16 autocast (its matmuls in bf16,
LayerNorm and softmax in float32); the embeddings and the head stay float32.
"""
from __future__ import annotations

import torch
from torch import nn

from .layers import PoolRN, SinusoidalPosEmb, Siren, TransformerEncoder, dense

__all__ = ["PlaneNet"]


class PlaneNet(nn.Module):
    """x: (B, N, 3) projected point cloud, t: (B,) timesteps ->
    (B, 3) skew-vec noise prediction."""

    def __init__(self, dim: int = 512, heads: int = 4, layers: int = 4,
                 bf16: bool = False):
        super().__init__()
        self.bf16 = bf16
        self.siren = Siren(3, dim // 2, scale=30)
        self.pos_emb = SinusoidalPosEmb(dim // 2)
        self.encoder = TransformerEncoder(dim, heads, layers)
        self.pool = PoolRN(dim)
        self.head = dense(dim, 3)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        x_emb = self.siren(x)  # (B, N, dim/2)
        t_tok = self.pos_emb(t)[:, None, :].expand_as(x_emb)
        h = torch.cat((x_emb, t_tok), dim=-1)  # (B, N, dim)
        with torch.autocast(h.device.type, dtype=torch.bfloat16, enabled=self.bf16):
            h = self.encoder(h)
        return self.head(self.pool(h.float()))
