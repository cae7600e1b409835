"""Model building blocks (counterpart of ``diffusion_extensions_tpu/models/layers.py``).

The encoder layer has PyTorch-1.8 ``nn.TransformerEncoderLayer`` semantics
(post-norm, ReLU, d_ff 2048, LayerNorm eps 1e-5, no dropout at
evaluation), batch-first.  Attention is
plain matmul / float32 softmax / matmul with q scaled by 1/sqrt(head_dim),
as flax's ``MultiHeadDotProductAttention`` computes it.  Dense layers start
from flax's default init (LeCun truncated normal, zero bias), so a seeded
model starts from the same distribution as the JAX package's.
"""
from __future__ import annotations

import math

import torch
from torch import nn

__all__ = [
    "dense",
    "SinusoidalPosEmb",
    "Siren",
    "ResMLPBlock",
    "PoolRN",
    "TransformerEncoderLayer",
    "TransformerEncoder",
]

# std of a unit normal truncated to [-2, 2], as flax's variance_scaling divides by
_TRUNC_STD = 0.87962566103423978
DIM_FEEDFORWARD = 2048


def dense(in_features: int, out_features: int) -> nn.Linear:
    """``nn.Linear`` with flax ``nn.Dense``'s default init."""
    lin = nn.Linear(in_features, out_features)
    std = math.sqrt(1.0 / in_features) / _TRUNC_STD
    nn.init.trunc_normal_(lin.weight, std=std, a=-2.0 * std, b=2.0 * std)
    nn.init.zeros_(lin.bias)
    return lin


class SinusoidalPosEmb(nn.Module):
    """Sin/cos timestep embedding."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        half_dim = self.dim // 2
        emb = math.log(10000) / (half_dim - 1)
        emb = torch.exp(torch.arange(half_dim, dtype=torch.float32, device=x.device) * -emb)
        emb = x.float()[:, None] * emb[None, :]
        return torch.cat((torch.sin(emb), torch.cos(emb)), dim=-1)


class Siren(nn.Module):
    """sin(Linear(x)) with SIREN init (weights U(+-sqrt(6/in)) * scale,
    bias U(+-pi)), then a plain Linear."""

    def __init__(self, in_channels: int, out_channels: int, scale: float = 1.0):
        super().__init__()
        self.lin = nn.Linear(in_channels, out_channels)
        bound = (6.0 / in_channels) ** 0.5
        with torch.no_grad():
            self.lin.weight.uniform_(-bound, bound).mul_(scale)
            self.lin.bias.uniform_(-3.14159, 3.14159)
        self.post = dense(out_channels, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.post(torch.sin(self.lin(x)))


class ResMLPBlock(nn.Module):
    """x + silu(Linear(x)), the reference's ``ResLayer(Sequential(Linear,
    SiLU))``."""

    def __init__(self, dim: int):
        super().__init__()
        self.lin = dense(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + torch.nn.functional.silu(self.lin(x))


class PoolRN(nn.Module):
    """Sigmoid-gated weighted mean pooling over the token axis."""

    def __init__(self, dim: int):
        super().__init__()
        self.gate = dense(dim, 1)
        self.val = dense(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight = torch.sigmoid(self.gate(x))
        w_sum = torch.clamp(torch.sum(weight, dim=-2), min=1e-6)
        return torch.sum(self.val(x) * weight, dim=-2) / w_sum


class TransformerEncoderLayer(nn.Module):
    """Post-norm self-attention + ReLU feed-forward block."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} is not divisible by heads {heads}")
        self.heads = heads
        self.query = dense(dim, dim)
        self.key = dense(dim, dim)
        self.value = dense(dim, dim)
        self.out = dense(dim, dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.ff1 = dense(dim, DIM_FEEDFORWARD)
        self.ff2 = dense(DIM_FEEDFORWARD, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)

    def _attention(self, x: torch.Tensor) -> torch.Tensor:
        b, s, dim = x.shape
        hd = dim // self.heads

        def split(y):  # (B, S, dim) -> (B, H, S, hd)
            return y.reshape(b, s, self.heads, hd).transpose(1, 2)

        q = split(self.query(x)) / math.sqrt(hd)
        k = split(self.key(x))
        v = split(self.value(x))
        logits = torch.matmul(q, k.transpose(-1, -2))
        weights = torch.softmax(logits.float(), dim=-1).to(v.dtype)
        o = torch.matmul(weights, v).transpose(1, 2).reshape(b, s, dim)
        return self.out(o)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self._attention(x))
        h = self.ff2(torch.relu(self.ff1(x)))
        return self.norm2(x + h)


class TransformerEncoder(nn.Module):
    """Stack of encoder layers (PlaneNet's: no final LayerNorm)."""

    def __init__(self, dim: int, heads: int, layers: int):
        super().__init__()
        self.layers = nn.ModuleList(TransformerEncoderLayer(dim, heads) for _ in range(layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x.float()
