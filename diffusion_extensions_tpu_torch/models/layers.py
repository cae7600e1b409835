"""Model building blocks (counterpart of ``diffusion_extensions_tpu/models/layers.py``).

The encoder layer has PyTorch-1.8 ``nn.TransformerEncoderLayer`` semantics
(post-norm, ReLU, d_ff 2048, LayerNorm eps 1e-5, no dropout at
evaluation), batch-first.  Attention is
plain matmul / float32 softmax / matmul with q scaled by 1/sqrt(head_dim),
as flax's ``MultiHeadDotProductAttention`` computes it; masked logits take
float32's most negative finite value, as flax gives them.  Dense layers start
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
    "PoolPos",
    "PoolFrame",
    "TransformerEncoderLayer",
    "TransformerCrossLayer",
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


def widen(x: torch.Tensor) -> torch.Tensor:
    """bf16 / fp16 activations (of autocast) -> float32; float32 and float64
    pass unchanged."""
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def _gate(x: torch.Tensor, gate: nn.Linear, mask) -> torch.Tensor:
    """sigmoid(gate(x)), zero on masked-out tokens (``mask`` (..., L) bool)."""
    weight = torch.sigmoid(gate(x))
    if mask is not None:
        weight = weight * mask[..., None].to(x.dtype)
    return weight


class PoolRN(nn.Module):
    """Sigmoid-gated weighted mean of projected features over the token
    axis; ``mask`` (..., L) bool keeps padding out."""

    def __init__(self, dim: int):
        super().__init__()
        self.gate = dense(dim, 1)
        self.val = dense(dim, dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        weight = _gate(x, self.gate, mask)
        w_sum = torch.clamp(torch.sum(weight, dim=-2), min=1e-6)
        return torch.sum(self.val(x) * weight, dim=-2) / w_sum


class PoolPos(nn.Module):
    """Sigmoid-gated weighted mean of positions (..., L, 3)."""

    def __init__(self, dim: int):
        super().__init__()
        self.gate = dense(dim, 1)

    def forward(self, x: torch.Tensor, pos: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        weight = _gate(x, self.gate, mask)
        w_sum = torch.clamp(torch.sum(weight, dim=-2), min=1e-6)
        return torch.sum(pos * weight, dim=-2) / w_sum


class PoolFrame(nn.Module):
    """Sigmoid-gated weighted means of per-token frame matrices, one per
    gate head: (..., L, D) features and (..., L, 3, 3) frames ->
    (..., heads * 9)."""

    def __init__(self, dim: int, heads: int = 4):
        super().__init__()
        self.heads = heads
        self.gate = dense(dim, heads)

    def forward(self, x: torch.Tensor, frames: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        w = _gate(x, self.gate, mask)  # (..., L, heads)
        w_sum = torch.clamp(torch.sum(w, dim=-2), min=1e-6)
        f = frames.reshape(*frames.shape[:-2], 9)
        pooled = torch.einsum("...lh,...lf->...hf", w, f) / w_sum[..., None]
        return pooled.reshape(*pooled.shape[:-2], self.heads * 9)


_MASKED = torch.finfo(torch.float32).min  # what flax gives a masked logit


class _AttentionBlock(nn.Module):
    """Post-norm attention + ReLU feed-forward block; queries from ``x``,
    keys and values from ``ctx``.  ``mask`` is a bool tensor broadcastable
    to (B, heads, Lq, Lk), True = attend: a masked logit becomes float32's
    most negative finite value before the softmax, as in flax.  The softmax
    runs in float32 under autocast (in float64 on float64 weights)."""

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

    def _attention(self, x: torch.Tensor, ctx: torch.Tensor, mask=None) -> torch.Tensor:
        b, s, dim = x.shape
        hd = dim // self.heads

        def split(y):  # (B, S, dim) -> (B, H, S, hd)
            return y.reshape(b, y.shape[1], self.heads, hd).transpose(1, 2)

        q = split(self.query(x)) / math.sqrt(hd)
        k = split(self.key(ctx))
        v = split(self.value(ctx))
        logits = widen(torch.matmul(q, k.transpose(-1, -2)))
        if mask is not None:
            logits = logits.masked_fill(~mask, _MASKED)
        weights = torch.softmax(logits, dim=-1).to(v.dtype)
        o = torch.matmul(weights, v).transpose(1, 2).reshape(b, s, dim)
        return self.out(o)

    def _block(self, x: torch.Tensor, ctx: torch.Tensor, mask) -> torch.Tensor:
        x = self.norm1(x + self._attention(x, ctx, mask))
        h = self.ff2(torch.relu(self.ff1(x)))
        return self.norm2(x + h)


class TransformerEncoderLayer(_AttentionBlock):
    """Post-norm self-attention + ReLU feed-forward block.  ``fused_qkv``
    (one (dim, 3 dim) projection) is the JAX package's option and waits for
    ROADMAP.md A.2."""

    def __init__(self, dim: int, heads: int, fused_qkv: bool = False):
        if fused_qkv:
            raise NotImplementedError("fused_qkv is not ported yet: ROADMAP.md A.2")
        super().__init__(dim, heads)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        return self._block(x, x, mask)


class TransformerCrossLayer(_AttentionBlock):
    """Post-norm cross-attention block: ``x`` attends to ``ctx``;
    ``ctx_mask`` (B, Lctx) bool keeps context padding out.  Returns
    float32 under autocast."""

    def forward(self, x: torch.Tensor, ctx: torch.Tensor,
                ctx_mask: torch.Tensor | None = None) -> torch.Tensor:
        mask = None if ctx_mask is None else ctx_mask[:, None, None, :]
        return widen(self._block(x, ctx, mask))


class TransformerEncoder(nn.Module):
    """Stack of encoder layers, with an optional final LayerNorm (ProtNet's
    has one, PlaneNet's not).

    ``key_padding_mask`` (B, L) bool, True = a token; ``attn_mask`` (a bool
    tensor broadcastable to (B, heads, L, L), True = attend) overrides it.
    Returns float32 under autocast."""

    def __init__(self, dim: int, heads: int, layers: int, final_norm: bool = False,
                 fused_qkv: bool = False):
        super().__init__()
        self.layers = nn.ModuleList(TransformerEncoderLayer(dim, heads, fused_qkv)
                                    for _ in range(layers))
        self.norm = nn.LayerNorm(dim, eps=1e-5) if final_norm else None

    def forward(self, x: torch.Tensor, key_padding_mask: torch.Tensor | None = None,
                attn_mask: torch.Tensor | None = None) -> torch.Tensor:
        mask = attn_mask
        if mask is None and key_padding_mask is not None:
            mask = key_padding_mask[:, None, None, :]
        for layer in self.layers:
            x = layer(x, mask)
        if self.norm is not None:
            x = self.norm(x)
        return widen(x)
