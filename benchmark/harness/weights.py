"""Weights made from the seed on the device, in one draw: a flat buffer
of standard normals, each leaf a slice of it scaled (``normal``, ``normal
around one``) or mapped to a uniform through the normal CDF
(``uniform``)."""
from __future__ import annotations

import math

import torch


def make(spec: list, seed: int, device, dtype=torch.float32) -> dict:
    """{name: tensor} of ``spec`` [(name, shape, (kind, scale))]; the
    tensors are views of one buffer."""
    total = sum(math.prod(shape) for _, shape, _ in spec)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, off = {}, 0
    for name, shape, (kind, scale) in spec:
        n = math.prod(shape)
        leaf = flat[off:off + n]
        off += n
        if kind == "normal":
            leaf.mul_(scale)
        elif kind == "normal_around_one":
            leaf.mul_(scale).add_(1.0)
        elif kind == "uniform":
            leaf.mul_(1 / math.sqrt(2)).erf_().mul_(scale)
        else:
            raise ValueError(f"unknown init {kind!r} for {name}")
        out[name] = leaf.view(shape)
    return out

