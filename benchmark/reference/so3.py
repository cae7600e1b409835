"""Rotation-matrix geometry, written from the formulas: Rodrigues'
exponential, the logarithm with its rotation-by-pi branch, fractional
powers, and Haar-QR draws."""
from __future__ import annotations

import math

import torch


def hat(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> the skew matrix [v]_x (..., 3, 3)."""
    z = torch.zeros_like(v[..., 0])
    x, y, w = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack((torch.stack((z, -w, y), -1), torch.stack((w, z, -x), -1),
                        torch.stack((-y, x, z), -1)), -2)


def mm(a: torch.Tensor, b: torch.Tensor, q=None) -> torch.Tensor:
    """a @ b, the operands rounded by ``q`` (``lowp.Rounded``) if given."""
    return a @ b if q is None else q.matmul(a, b)


def exp(v: torch.Tensor, q=None) -> torch.Tensor:
    """exp([v]_x) = I + sin(a)/a K + (1 - cos a)/a^2 K^2, a = |v|, with
    the Taylor terms below a = 1e-4."""
    a2 = (v * v).sum(-1)
    small = a2 < 1e-8
    a = torch.sqrt(torch.where(small, torch.ones_like(a2), a2))
    c1 = torch.where(small, 1 - a2 / 6, torch.sin(a) / a)
    c2 = torch.where(small, 0.5 - a2 / 24, (1 - torch.cos(a)) / torch.where(small, 1.0, a2))
    k = hat(v)
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    return eye + c1[..., None, None] * k + c2[..., None, None] * mm(k, k, q)


def log(r: torch.Tensor) -> torch.Tensor:
    """The rotation vector theta * axis of R, theta in [0, pi]: from the
    skew part away from pi, from (R + I) / 2 = n n^T at pi."""
    w = torch.stack((r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0],
                     r[..., 1, 0] - r[..., 0, 1]), -1)  # 2 sin(theta) n
    s = 0.5 * torch.linalg.vector_norm(w, dim=-1)
    c = 0.5 * (r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2] - 1)
    theta = torch.atan2(s, c)
    regular = torch.where(theta < 1e-6, torch.zeros_like(theta),
                          theta / torch.where(s < 1e-6, torch.ones_like(s), 2 * s))
    v = regular[..., None] * w
    nnt = 0.5 * (0.5 * (r + r.transpose(-1, -2)) + torch.eye(3, dtype=r.dtype, device=r.device))
    k = torch.argmax(torch.diagonal(nnt, dim1=-2, dim2=-1), -1)
    col = torch.gather(nnt, -1, k[..., None, None].expand(*k.shape, 3, 1))[..., 0]
    axis = col / torch.clamp(torch.linalg.vector_norm(col, dim=-1, keepdim=True), min=1e-8)
    at_pi = ((s < 1e-6) & (c < 0))[..., None]
    return torch.where(at_pi, theta[..., None] * axis, v)


def power(r: torch.Tensor, s: torch.Tensor, q=None) -> torch.Tensor:
    """R^s = exp(s log R); ``s`` has R's batch shape."""
    return exp(log(r) * s[..., None], q)


def power_both(r: torch.Tensor, s: torch.Tensor, q=None) -> tuple[torch.Tensor, torch.Tensor]:
    """R^s by both rotation vectors of R: theta n and -(2 pi - theta) n.
    Near theta = pi the two are the same rotation of R and a rounding
    picks either, but their powers differ: a check accepts the nearer."""
    v = log(r)
    theta = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    other = v * ((theta - 2 * math.pi) / torch.clamp(theta, min=1e-12))
    return exp(v * s[..., None], q), exp(other * s[..., None], q)


def angle_between(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The geodesic angle of a^T b, in [0, pi]."""
    r = a.transpose(-1, -2) @ b
    w = torch.stack((r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0],
                     r[..., 1, 0] - r[..., 0, 1]), -1)
    c = 0.5 * (r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2] - 1)
    return torch.atan2(0.5 * torch.linalg.vector_norm(w, dim=-1), c)


def haar_qr(gauss: torch.Tensor) -> torch.Tensor:
    """Q of the QR factorisation of iid normal 3x3 matrices (det +-1, not
    sign-fixed: the processes start from these)."""
    return torch.linalg.qr(gauss)[0]
