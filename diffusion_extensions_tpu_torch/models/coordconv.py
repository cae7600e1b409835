"""The jigsaw toy's convolutional denoiser (counterpart of
``diffusion_extensions_tpu/models/coordconv.py``).

The image is concatenated with a two-channel coordinate grid (``(gy, gx)``
of an ``ij`` meshgrid over ``linspace(-1, 1, size)``) and the broadcast
sinusoidal time embedding, then seven stages of 3x3 conv + ELU followed by a
2x2 / stride-2 max-pool (four convs in the first stage, two in the others),
a 3x3 conv to two channels and the mean over the image: (B, 2).

The layout is PyTorch's NCHW, the JAX package's NHWC with the channel axis
moved: the first spatial axis keeps its meaning (the x pixel of the
jigsaw's renderer), and the channels their order (image, gy, gx, time).
Convolutions start from flax's ``nn.Conv`` default init (LeCun truncated
normal over fan_in = 9 Cin, zero bias).  Seven pools need ``size`` >= 128.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from .layers import _TRUNC_STD, SinusoidalPosEmb

__all__ = ["CoordConv", "STAGES"]

# convs before each of the seven max-pools
STAGES = (4, 2, 2, 2, 2, 2, 2)
WIDTH = 32


def conv3x3(in_channels: int, out_channels: int) -> nn.Conv2d:
    """3x3 SAME conv with flax ``nn.Conv``'s default init."""
    conv = nn.Conv2d(in_channels, out_channels, 3, padding=1)
    std = math.sqrt(1.0 / (9 * in_channels)) / _TRUNC_STD
    nn.init.trunc_normal_(conv.weight, std=std, a=-2.0 * std, b=2.0 * std)
    nn.init.zeros_(conv.bias)
    return conv


class CoordConv(nn.Module):
    """x (B, 3, size, size), t (B,) -> (B, 2).  ``convs[i]`` is flax's
    ``Conv_i``: 16 convs of width 32, then ``convs[16]`` to two channels."""

    def __init__(self, size: int = 128, dim: int = 16):
        super().__init__()
        self.size, self.dim = size, dim
        self.time_emb = SinusoidalPosEmb(dim)
        widths = [3 + 2 + dim] + [WIDTH] * sum(STAGES)
        self.convs = nn.ModuleList(conv3x3(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.convs.append(conv3x3(WIDTH, 2))

    def coords(self, device) -> torch.Tensor:
        """(2, size, size): channel 0 varies along the first spatial axis."""
        lin = torch.linspace(-1.0, 1.0, self.size, device=device)
        gy, gx = torch.meshgrid(lin, lin, indexing="ij")
        return torch.stack((gy, gx))

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        t_map = self.time_emb(t).to(x.dtype)[:, :, None, None].expand(b, self.dim, h, w)
        coords = self.coords(x.device).to(x.dtype)[None].expand(b, 2, h, w)
        h_ = torch.cat((x, coords, t_map), dim=1)
        convs = iter(self.convs)
        for n in STAGES:
            for _ in range(n):
                h_ = F.elu(next(convs)(h_))
            h_ = F.max_pool2d(h_, 2, 2)
        return next(convs)(h_).mean(dim=(2, 3))
