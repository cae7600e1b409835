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
import torch.distributed as dist
from torch import nn

__all__ = [
    "dense",
    "SinusoidalPosEmb",
    "Siren",
    "ResLayer",
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


class ResLayer(nn.Module):
    """x + layer(x), the reference's residual wrapper."""

    def __init__(self, layer: nn.Module):
        super().__init__()
        self.layer = layer

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.layer(x)


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


class _SumOverRanks(torch.autograd.Function):
    """All-reduce (sum) over ``group``; the gradient is summed alike."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherTokens(torch.autograd.Function):
    """The token axis (dim 1) of every rank of ``group``, in rank order; the
    backward sums the gradient over the ranks and keeps this rank's slice
    (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return grad.chunk(n, dim=1)[r].contiguous(), None


def _sp_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the sequence-parallel ranks of ``group`` (none: as
    it is); differentiable."""
    return x if group is None else _SumOverRanks.apply(x, group)


def _sp_gather(x: torch.Tensor, group) -> torch.Tensor:
    """The tokens (dim 1) of every sequence-parallel rank of ``group``, in
    rank order (none: ``x``); differentiable."""
    return x if group is None else _GatherTokens.apply(x, group)


class PoolRN(nn.Module):
    """Sigmoid-gated weighted mean of projected features over the token
    axis; ``mask`` (..., L) bool keeps padding out.  With ``sp_group`` set
    (sequence parallelism) each rank holds a slice of the tokens and both
    sums are all-reduced over the group."""

    def __init__(self, dim: int):
        super().__init__()
        self.gate = dense(dim, 1)
        self.val = dense(dim, dim)
        self.sp_group = None

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        weight = _gate(x, self.gate, mask)
        w_sum = torch.clamp(_sp_sum(torch.sum(weight, dim=-2), self.sp_group), min=1e-6)
        return _sp_sum(torch.sum(self.val(x) * weight, dim=-2), self.sp_group) / w_sum


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
_FUSED_MASKED = -1e9  # what the JAX package's FusedSelfAttention gives one


class _AttentionBlock(nn.Module):
    """Post-norm attention + ReLU feed-forward block; queries from ``x``,
    keys and values from ``ctx``.  ``mask`` is a bool tensor broadcastable
    to (B, heads, Lq, Lk), True = attend: a masked logit becomes float32's
    most negative finite value before the softmax, as in flax.  The softmax
    runs in float32 under autocast (in float64 on float64 weights).

    ``moe_experts > 0`` replaces the feed-forward pair with a Switch MoE
    (``models/moe.py``).  The number of heads a call computes is the
    projections' width over ``head_dim``, so a block whose q / k / v are
    column-sharded over tensor-parallel ranks runs its own heads.  With
    ``sp_group`` set (sequence parallelism) keys and values are gathered
    over the group's ranks, each of which holds a slice of the tokens."""

    def __init__(self, dim: int, heads: int, fused_qkv: bool = False, moe_experts: int = 0,
                 moe_dispatch: str = "onehot"):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} is not divisible by heads {heads}")
        self.heads, self.head_dim = heads, dim // heads
        self.fused_qkv = fused_qkv
        self.sp_group = None
        if fused_qkv:
            self.qkv = dense(dim, 3 * dim)
        else:
            self.query = dense(dim, dim)
            self.key = dense(dim, dim)
            self.value = dense(dim, dim)
        self.out = dense(dim, dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        if moe_experts > 0:
            from .moe import MoEFFN

            self.moe = MoEFFN(dim, moe_experts, DIM_FEEDFORWARD, dispatch=moe_dispatch)
        else:
            self.moe = None
            self.ff1 = dense(dim, DIM_FEEDFORWARD)
            self.ff2 = dense(DIM_FEEDFORWARD, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)

    def _fused_attention(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        """Self-attention through one (dim, 3 dim) projection, as the JAX
        package's ``FusedSelfAttention`` computes it: logits q.k scaled by
        1/sqrt(head_dim) after the product, masked logits set to -1e9 in
        the logits' dtype, the softmax in float32 cast back."""
        b, s, dim = x.shape
        hd = dim // self.heads
        qkv = self.qkv(x).reshape(b, s, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (B, H, S, hd)
        logits = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(hd))
        if mask is not None:
            logits = logits.masked_fill(~mask, _FUSED_MASKED)
        weights = torch.softmax(widen(logits), dim=-1).to(v.dtype)
        o = torch.matmul(weights, v).transpose(1, 2).reshape(b, s, dim)
        return self.out(o)

    def _attention(self, x: torch.Tensor, ctx: torch.Tensor, mask=None) -> torch.Tensor:
        if self.fused_qkv:
            return self._fused_attention(x, mask)
        b, s = x.shape[:2]
        hd = self.head_dim

        def split(y):  # (B, S, H * hd) -> (B, H, S, hd)
            return y.reshape(b, y.shape[1], -1, hd).transpose(1, 2)

        q = split(self.query(x)) / math.sqrt(hd)
        k = split(_sp_gather(self.key(ctx), self.sp_group))
        v = split(_sp_gather(self.value(ctx), self.sp_group))
        logits = widen(torch.matmul(q, k.transpose(-1, -2)))
        if mask is not None:
            logits = logits.masked_fill(~mask, _MASKED)
        weights = torch.softmax(logits, dim=-1).to(v.dtype)
        o = torch.matmul(weights, v).transpose(1, 2).reshape(b, s, -1)
        return self.out(o)

    def _block(self, x: torch.Tensor, ctx: torch.Tensor, mask) -> torch.Tensor:
        x = self.norm1(x + self._attention(x, ctx, mask))
        h = self.moe(x) if self.moe is not None else self.ff2(torch.relu(self.ff1(x)))
        return self.norm2(x + h)


class TransformerEncoderLayer(_AttentionBlock):
    """Post-norm self-attention + ReLU feed-forward block.  ``fused_qkv``:
    one (dim, 3 dim) projection for q, k and v (the JAX package's
    ``FusedSelfAttention``); ``moe_experts > 0``: a Switch MoE in place of
    the feed-forward pair, dispatched by ``moe_dispatch``."""

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
    ``moe_experts`` / ``moe_dispatch`` go to every layer (the JAX layers'
    default dispatch is "onehot").  Returns float32 under autocast."""

    def __init__(self, dim: int, heads: int, layers: int, final_norm: bool = False,
                 fused_qkv: bool = False, moe_experts: int = 0, moe_dispatch: str = "onehot"):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(dim, heads, fused_qkv, moe_experts, moe_dispatch)
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
