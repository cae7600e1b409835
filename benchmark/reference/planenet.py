"""PlaneNet, the aircraft denoiser (rotational alignment of point clouds):
a SIREN point embedding (dim/2) beside a sinusoidal timestep embedding
(dim/2), a post-norm transformer encoder over the points (ReLU
feed-forward of 2048, no final norm), a sigmoid-gated mean over the points
and a linear head to the (3,) skew-vector noise estimate."""
from __future__ import annotations

import torch

from . import nn


def param_spec(cfg: dict) -> list:
    dim, half = cfg["dim"], cfg["dim"] // 2
    spec = nn.siren_spec("siren", 3, half, 30.0)
    for i in range(cfg["layers"]):
        spec += nn.block_spec(f"encoder.layers.{i}", dim)
    spec += nn.dense_spec("pool.gate", dim, 1) + nn.dense_spec("pool.val", dim, dim)
    return spec + nn.dense_spec("head", dim, 3)


def forward(p: dict, cfg: dict, x: torch.Tensor, t: torch.Tensor, q=None) -> torch.Tensor:
    """x (B, N, 3) rotated clouds, t (B,) -> (B, 3); ``q`` rounds the
    encoder's products (the region the configuration runs in bf16)."""
    half = cfg["dim"] // 2
    emb = nn.siren(p, "siren", x)
    t_tok = nn.sinusoidal(t, half, x.dtype)[:, None, :].expand_as(emb)
    h = torch.cat((emb, t_tok), -1)
    for i in range(cfg["layers"]):
        h = nn.attention_block(p, f"encoder.layers.{i}", h, h, cfg["heads"], q=q)
    pooled = nn.gated_mean(p, "pool", h, nn.linear(p, "pool.val", h))[:, 0]
    return nn.linear(p, "head", pooled)
