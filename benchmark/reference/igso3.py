"""IGSO(3) noise as the diffusion processes draw it: the heat-kernel
density on SO(3) as a float64 series, its trapezoid CDF on the angle grid
pi (i / 999)^3, a quantile table at rational-cubic knots, and the draw of
one training step from a ``torch.Generator``.

The draw order is the processes' stated semantics, which both sides of a
comparison follow from one seed: t ~ U{0..T-1} (``randint``), then a
uniform (the angle's quantile) and three normals (the axis) per row, and
for SE(3) three more normals (the shift).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import so3

_PI = math.pi
GRID = 1000
QUANTILES = 1024


def density(t: np.ndarray, eps: np.ndarray) -> np.ndarray:
    """f(t) = sqrt(pi) var^(-3/2) e^(var/4) e^(-(t/2)^2/var) A(t) /
    (2 sin(t/2)), var = eps^2, with the t = 0 limit; float64 in,
    non-finite terms set to 0, float32 out."""
    t, var = np.broadcast_arrays(np.asarray(t, np.float64), np.asarray(eps, np.float64) ** 2)
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        a = t - np.exp(-_PI ** 2 / var) * ((t - 2 * _PI) * np.exp(_PI * t / var)
                                            + (t + 2 * _PI) * np.exp(-_PI * t / var))
        f = (math.sqrt(_PI) * var ** -1.5 * np.exp(var / 4) * np.exp(-(t / 2) ** 2 / var)
             * a / (2 * np.sin(t / 2)))
        f = np.where(np.isfinite(f), f, 0.0)
        limit = (math.sqrt(_PI) * (var * np.exp(2 * _PI ** 2 / var) - 2 * var * np.exp(_PI ** 2 / var)
                                   + 4 * _PI ** 2 * var * np.exp(_PI ** 2 / var))
                 * np.exp(var / 4 - 2 * _PI ** 2 / var) / var ** 2.5)
        f = np.where(t == 0, limit, f)
    return f.astype(np.float32)


def quantile_table(eps: np.ndarray) -> np.ndarray:
    """(K, QUANTILES) float32 angles: the inverse of each level's CDF at
    the knots u_k = m(k / (Q - 1)), m(s) = s^3 / (s^3 + (1 - s)^3)."""
    eps = np.asarray(eps, np.float32).reshape(-1)
    locs = np.float32(_PI) * np.linspace(0, 1, GRID, dtype=np.float32) ** np.float32(3)
    f = density(locs, eps[:, None])
    with np.errstate(invalid="ignore"):
        vals = f * ((1.0 - np.cos(locs)) / _PI).astype(np.float32)
    vals[:, 0] = 0.0
    cdf = np.cumsum(np.diff(locs) * (vals[:, :-1] + vals[:, 1:]) / 2.0, axis=-1, dtype=np.float32)
    total = cdf[:, -1:]
    cdf = np.where(total > 0, cdf / np.maximum(total, 1e-38), 1.0).astype(np.float32)
    knots_s = np.linspace(0.0, 1.0, QUANTILES)
    u = np.minimum(knots_s ** 3 / (knots_s ** 3 + (1 - knots_s) ** 3), 1 - 1e-7).astype(np.float32)
    locs = locs[1:]
    n = cdf.shape[-1]
    out = np.empty((len(eps), QUANTILES), np.float32)
    for k, row in enumerate(cdf):
        hi = np.minimum(np.searchsorted(row, u, side="right"), n - 1)
        lo = np.maximum(hi - 1, 0)
        w = np.clip((u - row[lo]) / np.maximum(row[hi] - row[lo], 1e-6), 0.0, 1.0)
        out[k] = locs[lo] + w * (locs[hi] - locs[lo])
    return out


def quantile_angle(table: torch.Tensor, u: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The table's inverse CDF of level ``idx`` at ``u``, linear between
    knots; in float32, as the table is."""
    q = table.shape[-1]
    u = torch.clamp(u, 0.0, 1.0 - 1e-7)
    r = (u / torch.clamp(1.0 - u, min=1e-12)).pow(1.0 / 3.0)
    pos = r / (1.0 + r) * (q - 1)
    k0 = torch.clamp(torch.floor(pos).long(), max=q - 2)
    frac = pos - k0
    a0, a1 = table[idx, k0], table[idx, k0 + 1]
    return a0 + frac * (a1 - a0)


def draw_step(generator: torch.Generator, table: torch.Tensor, eps: torch.Tensor,
              batch: int, se3: bool, dtype=torch.float64):
    """One training step's randomness: (t, noise rotation, unit shift
    normal or None), the rotation exp(theta n) in ``dtype``."""
    dev = table.device
    t = torch.randint(0, table.shape[0], (batch,), generator=generator, device=dev)
    u = torch.rand((batch,), generator=generator, device=dev)
    axes = torch.randn((batch, 3), generator=generator, device=dev)
    z = torch.randn((batch, 3), generator=generator, device=dev) if se3 else None
    theta = quantile_angle(table, u, t).to(dtype)
    axes = axes.to(dtype)
    axes = axes / torch.clamp(torch.linalg.vector_norm(axes, dim=-1, keepdim=True), min=1e-12)
    rot = so3.exp(axes * theta[:, None])
    return t, rot, (None if z is None else z.to(dtype))
