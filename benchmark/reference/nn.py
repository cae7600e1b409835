"""Layers the denoisers share, as functions of a dict of weights.

``q`` is the precision of the matrix products that the configuration runs
below float32 (its autocast region): None computes them in the weights'
dtype; a ``lowp.Rounded`` rounds the operands of each product and of its
backward (the control's lower precision, ``lowp.FP8``)."""
from __future__ import annotations

import math

import torch
from torch.nn import functional as F

DIM_FEEDFORWARD = 2048


def linear(p: dict, name: str, x: torch.Tensor, q=None) -> torch.Tensor:
    w, b = p[name + ".weight"], p[name + ".bias"]
    if q is not None:
        return q.matmul(x, w.T) + b
    return F.linear(x, w, b)


def matmul(a: torch.Tensor, b: torch.Tensor, q=None) -> torch.Tensor:
    return a @ b if q is None else q.matmul(a, b)


def layer_norm(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"], p[name + ".bias"], 1e-5)


def sinusoidal(t: torch.Tensor, dim: int, dtype) -> torch.Tensor:
    """(B,) timesteps -> (B, dim): sin and cos of t * 10000^(-i / (dim/2 - 1))."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=dtype, device=t.device)
                      * -(math.log(10000) / (half - 1)))
    arg = t.to(dtype)[:, None] * freqs[None]
    return torch.cat((torch.sin(arg), torch.cos(arg)), -1)


def siren(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """post(sin(lin(x)))."""
    return linear(p, name + ".post", torch.sin(linear(p, name + ".lin", x)))


def attention_block(p: dict, name: str, x, ctx, heads: int, mask=None, q=None):
    """Post-norm block: x = LN(x + MHA(x, ctx)); x = LN(x + W2 relu(W1 x)).
    ``mask`` (B, 1 or heads, Lq, Lk) bool, True = attend; logits scaled by
    1/sqrt(head dim); masked logits take the dtype's most negative value."""
    b, lq, dim = x.shape
    hd = dim // heads

    def split(y):
        return y.reshape(b, y.shape[1], heads, hd).transpose(1, 2)

    qh = split(linear(p, name + ".query", x, q)) / math.sqrt(hd)
    kh = split(linear(p, name + ".key", ctx, q))
    vh = split(linear(p, name + ".value", ctx, q))
    logits = matmul(qh, kh.transpose(-1, -2), q)
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
    o = matmul(torch.softmax(logits, -1), vh, q).transpose(1, 2).reshape(b, lq, dim)
    x = layer_norm(p, name + ".norm1", x + linear(p, name + ".out", o, q))
    h = linear(p, name + ".ff2", torch.relu(linear(p, name + ".ff1", x, q)), q)
    return layer_norm(p, name + ".norm2", x + h)


def gated_mean(p: dict, name: str, x, values, mask=None):
    """sum_l sigmoid(gate(x_l)) values_l / sum_l sigmoid(gate(x_l)) over
    the valid tokens (sums clamped at 1e-6); one gate head per column of
    the gate, values (B, L, F) -> (B, heads, F)."""
    w = torch.sigmoid(linear(p, name + ".gate", x))
    if mask is not None:
        w = w * mask[..., None].to(w.dtype)
    w_sum = torch.clamp(w.sum(-2), min=1e-6)
    return torch.einsum("blh,blf->bhf", w, values) / w_sum[..., None]


def dense_spec(name: str, fan_in: int, fan_out: int, gain: float = 1.0) -> list:
    """A dense layer's weights: normal with std gain/sqrt(fan_in), small
    normal biases."""
    return [(name + ".weight", (fan_out, fan_in), ("normal", gain / math.sqrt(fan_in))),
            (name + ".bias", (fan_out,), ("normal", 0.02))]


def norm_spec(name: str, dim: int) -> list:
    return [(name + ".weight", (dim,), ("normal_around_one", 0.02)),
            (name + ".bias", (dim,), ("normal", 0.02))]


def siren_spec(name: str, fan_in: int, width: int, scale: float) -> list:
    """SIREN's first layer: U(+-sqrt(6 / fan_in)) * scale, bias U(+-pi)."""
    return [(name + ".lin.weight", (width, fan_in), ("uniform", math.sqrt(6.0 / fan_in) * scale)),
            (name + ".lin.bias", (width,), ("uniform", math.pi))] + dense_spec(name + ".post", width, width)


def block_spec(name: str, dim: int) -> list:
    out = []
    for part in ("query", "key", "value", "out"):
        out += dense_spec(f"{name}.{part}", dim, dim)
    out += norm_spec(name + ".norm1", dim)
    out += dense_spec(name + ".ff1", dim, DIM_FEEDFORWARD) + dense_spec(name + ".ff2", DIM_FEEDFORWARD, dim)
    return out + norm_spec(name + ".norm2", dim)
