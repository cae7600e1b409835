"""Lower precisions for the control: the operands of each matrix product
rounded before it is taken, in the forward and, for training, in both
products of its backward.

``FP8``: e4m3 with one scale per tensor (amax / 448), as fp8 matrix
products take them; the step below the bf16 that the configurations
state for their autocast regions.  ``TF32``: float32 with the mantissa
rounded to 10 bits (to nearest, ties to even), what a product takes when
TF32 is allowed; the step below the float32 that the rotation products
state."""
from __future__ import annotations

import torch

FP8_MAX = 448.0


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    x = x.detach()
    scale = torch.clamp(x.abs().amax(), min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.detach().float().contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32).to(x.dtype)


class _Product(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, rnd):
        qa, qb = rnd(a), rnd(b)
        ctx.save_for_backward(qa, qb)
        ctx.rnd = rnd
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = ctx.rnd(g)
        ga = qg @ qb.transpose(-1, -2)
        gb = qa.transpose(-1, -2) @ qg
        while ga.dim() > qa.dim():
            ga = ga.sum(0)
        while gb.dim() > qb.dim():
            gb = gb.sum(0)
        return ga, gb, None


class Rounded:
    """A precision: ``matmul(a, b)`` with both operands (and the backward's
    incoming gradient) rounded by ``rnd``."""

    def __init__(self, name: str, rnd):
        self.name, self.rnd = name, rnd

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _Product.apply(a, b, self.rnd)


FP8 = Rounded("fp8_e4m3", round_fp8)
TF32 = Rounded("tf32", round_tf32)
