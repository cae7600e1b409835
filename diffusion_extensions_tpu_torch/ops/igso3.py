"""Isotropic Gaussian on SO(3): density, score and table-based sampling
(counterpart of ``diffusion_extensions_tpu/ops/igso3.py``).

* ``igso3_log_density`` / ``igso3_score_angle``: the float32-safe log-space
  heat-kernel density and its closed-form angle derivative.  Their fused
  CUDA kernel is ``igso3_cuda.igso3_logpdf_score``, which ``igso3_score_vec``
  and ``IsotropicGaussianSO3.log_prob`` call.
* ``igso3_series_np``, ``cdf_locs``, ``build_cdf_np``, ``build_inv_cdf_np``:
  numpy copies of the host-side table builders (float64 series, float32
  trapezoid CDF, rational-cubic quantile table).
* ``IGSO3Table``: per-noise-level CDF and quantile tables, built once;
  sampling is two point gathers and a lerp (``sample_angles_exact``: the
  reference's bracketing of the full CDF row).
* ``IsotropicGaussianSO3`` and ``IGSO3xR3``: the reference's distribution
  classes, IGSO(3) about a mean rotation and its product with a Gaussian
  shift; their ``log_prob`` runs the fused kernel.
* ``Bingham``: the Bingham experiment's target, a projected Gaussian on the
  quaternion 3-sphere.

Density (``var = sigma**2``):

    f(t) = sqrt(pi) var^(-3/2) e^(var/4) e^(-(t/2)^2/var) A(t) / (2 sin(t/2)),
    A(t) = t - (t-2pi) e^((pi t - pi^2)/var) - (t+2pi) e^(-(pi t + pi^2)/var)
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from .igso3_cuda import igso3_logpdf_score
from .se3 import AffineT
from .so3 import exp_skewvec, rmat_to_aa, rmul, rotation_angle

__all__ = [
    "igso3_series_np",
    "igso3_log_density",
    "igso3_density",
    "igso3_score_angle",
    "igso3_score_vec",
    "igso3_log_prob_haar",
    "cdf_locs",
    "build_cdf_np",
    "build_cdf",
    "build_inv_cdf_np",
    "IGSO3Table",
    "IsotropicGaussianSO3",
    "IGSO3xR3",
    "Bingham",
]

_PI = math.pi


# ---------------------------------------------------------------------------
# Reference-exact density (host, numpy float64 -> float32)
# ---------------------------------------------------------------------------

def igso3_series_np(t: np.ndarray, eps: np.ndarray) -> np.ndarray:
    """Float64 series with inf/nan scrubbed to 0 and the reference's t == 0
    patch (its limit constant included), cast to float32."""
    t_d, var_d = np.broadcast_arrays(
        np.asarray(t, dtype=np.float64), np.asarray(eps, dtype=np.float64) ** 2
    )
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        vals = (
            math.sqrt(_PI)
            * var_d ** (-3 / 2)
            * np.exp(var_d / 4)
            * np.exp(-((t_d / 2) ** 2) / var_d)
            * (
                t_d
                - np.exp((-_PI**2) / var_d)
                * (
                    (t_d - 2 * _PI) * np.exp(_PI * t_d / var_d)
                    + (t_d + 2 * _PI) * np.exp(-_PI * t_d / var_d)
                )
            )
            / (2 * np.sin(t_d / 2))
        )
    vals = np.where(np.isinf(vals) | np.isnan(vals), 0.0, vals)
    with np.errstate(over="ignore", invalid="ignore"):
        limit = (
            math.sqrt(_PI)
            * (
                var_d * np.exp(2 * _PI**2 / var_d)
                - 2 * var_d * np.exp(_PI**2 / var_d)
                + 4 * _PI**2 * var_d * np.exp(_PI**2 / var_d)
            )
            * np.exp(var_d / 4 - (2 * _PI**2) / var_d)
            / var_d ** (5 / 2)
        )
        vals = np.where(t_d == 0, limit, vals)
    return vals.astype(np.float32)


# ---------------------------------------------------------------------------
# Float32-safe log-space density + analytic score (plain PyTorch)
# ---------------------------------------------------------------------------

def _rdiv(c: float, x: torch.Tensor) -> torch.Tensor:
    """c / x, correctly rounded.  torch evaluates ``scalar / tensor`` as
    ``scalar * reciprocal(tensor)``, which rounds twice; the JAX package and
    the kernel divide once."""
    return torch.full_like(x, c) / x


def _wrap_terms(t: torch.Tensor, var: torch.Tensor):
    """A(t) and A'(t) regrouped as

        A(t)  = t (1 - 2 q cosh x) + 4 pi q sinh x,      x = pi t / var,
        A'(t) = (1 - 2 q cosh x) - 2 t (pi/var) q sinh x + (4 pi^2/var) q cosh x

    with q = e^(-pi^2/var): q sinh x directly for x < 1, else
    (e1 -/+ e2)/2 with both exponents <= 0 on [0, pi]."""
    u = _rdiv(_PI, var)
    x = u * t
    e1 = torch.exp(x - _PI * u)
    e2 = torch.exp(-x - _PI * u)
    small_x = x < 1.0
    x_s = torch.where(small_x, x, torch.zeros_like(x))
    q = torch.exp(-_PI * u)
    qs = torch.where(small_x, q * torch.sinh(x_s), 0.5 * (e1 - e2))
    qc = torch.where(small_x, q * torch.cosh(x_s), 0.5 * (e1 + e2))
    one_m2qc = 1.0 - 2.0 * qc
    a = t * one_m2qc + 4.0 * _PI * qs
    da = one_m2qc - 2.0 * t * u * qs + 4.0 * _PI * u * qc
    return a, da


def igso3_log_density(t: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """log f(t; sigma) over the rotation angle, without the Haar factor;
    finite in float32 for sigma down to ~1e-3 and all t in [0, pi]."""
    t, sigma = torch.broadcast_tensors(t, sigma)
    var = sigma * sigma
    a, da = _wrap_terms(t, var)
    small = t < 1e-6
    t_safe = torch.where(small, torch.ones_like(t), t)
    ratio = torch.where(small, da, a / (2.0 * torch.sin(t_safe / 2.0)))
    # the reference's patch constant at exactly t == 0
    q = torch.exp(_rdiv(-_PI * _PI, var))
    ref_limit = 1.0 - 2.0 * q + 4.0 * _PI * _PI * q
    ratio = torch.where(t == 0.0, ref_limit, ratio)
    log_c = (
        0.5 * math.log(_PI)
        - 1.5 * torch.log(var)
        + var / 4.0
        - (t * t) / (4.0 * var)
    )
    return log_c + torch.log(torch.clamp(ratio, min=1e-38))


def igso3_density(t: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    return torch.exp(igso3_log_density(t, sigma))


def igso3_score_angle(t: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """d/dt log f(t; sigma); below t = 1e-4 the analytic limit
    A''(0)/(2 A'(0)) + t/12 - t/(2 var)."""
    t, sigma = torch.broadcast_tensors(t, sigma)
    var = sigma * sigma
    a, da = _wrap_terms(t, var)
    small = t < 1e-4
    one = torch.ones_like(t)
    t_safe = torch.where(small, one, t)
    direct = (
        -t / (2.0 * var)
        + da / torch.where(small, one, a)
        - 0.5 / torch.tan(t_safe / 2.0)
    )
    q = torch.exp(_rdiv(-_PI * _PI, var))
    dd_a0 = -2.0 * _PI * q / var
    d_a0 = 1.0 + 2.0 * q * (_rdiv(2.0 * _PI * _PI, var) - 1.0)
    limit = dd_a0 / (2.0 * d_a0) + t / 12.0 - t / (2.0 * var)
    return torch.where(small, limit, direct)


def igso3_score_vec(r_mat: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Riemannian score at R in tangent skew-vec coordinates:
    axis(R) * d/dtheta log f(theta; sigma), through the fused kernel."""
    axis, angle = rmat_to_aa(r_mat)
    theta = angle[..., 0]
    sigma = torch.as_tensor(sigma, dtype=theta.dtype, device=theta.device)
    _, score = igso3_logpdf_score(theta, sigma)
    return axis * score[..., None]


def igso3_log_prob_haar(t: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """log of the density over SO(3) with respect to the angle: the
    log-density plus the log of the (1 - cos t) / pi Haar factor that the
    reference's sampler uses and its ``log_prob`` leaves out."""
    return igso3_log_density(t, sigma) + torch.log(
        torch.clamp((1.0 - torch.cos(t)) / _PI, min=1e-38))


# ---------------------------------------------------------------------------
# Inverse-CDF tables
# ---------------------------------------------------------------------------

_GRID_N = 1000
_QUANTILES = 1024


def cdf_locs() -> np.ndarray:
    """The reference's angle grid pi * linspace(0, 1, 1000)^3, in float32."""
    lin = np.linspace(0.0, 1.0, _GRID_N, dtype=np.float32)
    return np.float32(_PI) * (lin ** np.float32(3.0))


def build_cdf_np(eps: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(trap_locs (999,), cdf (*eps.shape, 999)): float64 density, float32
    trapezoid CDF, grid axis last.  Rows whose mass underflows are a delta
    at angle ~0 (cdf == 1)."""
    eps = np.asarray(eps, dtype=np.float32)
    locs = cdf_locs()
    f = igso3_series_np(locs, eps[..., None])
    with np.errstate(invalid="ignore"):
        vals = f * ((1.0 - np.cos(locs)) / _PI).astype(np.float32)
    vals[..., locs == 0] = 0.0
    sums = vals[..., :-1] + vals[..., 1:]
    diffs = np.diff(locs)
    trap = np.cumsum(diffs * sums / 2.0, axis=-1, dtype=np.float32)
    total = trap[..., -1:]
    trap = np.where(total > 0.0, trap / np.maximum(total, 1e-38), 1.0)
    return locs[1:], trap


def build_cdf(eps: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The same table from the float32 log-space density, on ``eps``'s device."""
    locs = torch.from_numpy(cdf_locs()).to(eps.device)
    f = igso3_density(locs, eps[..., None])
    vals = f * ((1.0 - torch.cos(locs)) / _PI)
    vals = torch.where(locs == 0.0, torch.zeros_like(vals), vals)
    sums = vals[..., :-1] + vals[..., 1:]
    diffs = torch.diff(locs)
    trap = torch.cumsum(diffs * sums / 2.0, dim=-1)
    total = trap[..., -1:]
    trap = torch.where(
        total > 0.0, trap / torch.clamp(total, min=1e-38), torch.ones_like(trap)
    )
    return locs[1:], trap


def _angles_from_unif(unif, trap_locs, cdf):
    """Reference count/gather/lerp inverse transform, one angle per row."""
    idx_1 = torch.sum(cdf <= unif[..., None], dim=-1)
    idx_1 = torch.clamp(idx_1, max=cdf.shape[-1] - 1)
    idx_0 = torch.clamp(idx_1 - 1, min=0)
    trap_start = torch.gather(cdf, -1, idx_0[..., None])[..., 0]
    trap_end = torch.gather(cdf, -1, idx_1[..., None])[..., 0]
    trap_diff = torch.clamp(trap_end - trap_start, min=1e-6)
    weight = torch.clamp((unif - trap_start) / trap_diff, 0.0, 1.0)
    angle_start = trap_locs[idx_0]
    angle_end = trap_locs[idx_1]
    return angle_start + weight * (angle_end - angle_start)


def _inverse_cdf_angles(generator, trap_locs, cdf, unif=None):
    """One angle per CDF row (..., 999) by the reference's inverse
    transform, from ``unif`` (uniform on [0, 1), of ``cdf.shape[:-1]``) or
    uniforms drawn from ``generator``."""
    if unif is None:
        unif = torch.rand(cdf.shape[:-1], generator=generator, device=cdf.device,
                          dtype=cdf.dtype)
    return _angles_from_unif(unif, trap_locs, cdf)


def _quantile_knots(q: int) -> np.ndarray:
    """Knots u_k = m(k/(q-1)), m(s) = s^3 / (s^3 + (1-s)^3): cubic packing
    at both ends of the quantile range."""
    s = np.linspace(0.0, 1.0, q)
    u = s**3 / (s**3 + (1.0 - s) ** 3)
    return np.minimum(u, 1.0 - 1e-7)


def _quantile_pos(u: torch.Tensor, q: int) -> torch.Tensor:
    """Fractional knot index of ``u``: the inverse of the knot map.  The
    cube root is ``pow(1/3)`` of a non-negative value (torch has no cbrt);
    it differs from a true cbrt by an ulp or so."""
    r = (u / torch.clamp(1.0 - u, min=1e-12)).pow(1.0 / 3.0)
    s = r / (1.0 + r)
    return s * (q - 1)


def build_inv_cdf_np(trap_locs: np.ndarray, cdf: np.ndarray, q: int = _QUANTILES) -> np.ndarray:
    """Quantile table: piecewise-linear inversion of each CDF row at ``q``
    rational-cubic knots, with the same ``cdf <= u`` bracketing."""
    cdf = np.asarray(cdf, dtype=np.float32)
    locs = np.asarray(trap_locs, dtype=np.float32)
    flat = cdf.reshape(-1, cdf.shape[-1])
    u = _quantile_knots(q).astype(np.float32)
    out = np.empty((flat.shape[0], q), dtype=np.float32)
    n = cdf.shape[-1]
    for r in range(flat.shape[0]):
        row = flat[r]
        idx_1 = np.minimum(np.searchsorted(row, u, side="right").astype(np.int64), n - 1)
        idx_0 = np.maximum(idx_1 - 1, 0)
        t_start, t_end = row[idx_0], row[idx_1]
        w = np.clip((u - t_start) / np.maximum(t_end - t_start, 1e-6), 0.0, 1.0)
        out[r] = locs[idx_0] + w * (locs[idx_1] - locs[idx_0])
    return out.reshape(*cdf.shape[:-1], q)


def _random_axes(generator, shape, device) -> torch.Tensor:
    axes = torch.randn((*shape, 3), generator=generator, device=device)
    return axes / torch.clamp(torch.linalg.norm(axes, dim=-1, keepdim=True), min=1e-12)


@dataclass(frozen=True)
class IGSO3Table:
    """CDF (K, 999) and quantile (K, 1024) tables for K fixed noise levels,
    built once on the host and indexed by level on the device."""

    trap_locs: torch.Tensor  # (999,)
    cdf: torch.Tensor  # (K, 999)
    inv_cdf: torch.Tensor  # (K, 1024)
    eps: torch.Tensor  # (K,)

    @classmethod
    def from_eps(cls, eps, device=None) -> "IGSO3Table":
        device = resolve_device(device)
        eps = np.asarray(eps, dtype=np.float32).reshape(-1)
        locs, cdf = build_cdf_np(eps)
        inv = build_inv_cdf_np(locs, cdf)

        def dev(a):
            return torch.tensor(a, device=device)

        return cls(dev(locs), dev(cdf), dev(inv), dev(eps))

    @property
    def device(self) -> torch.device:
        return self.cdf.device

    def sample_angles(self, generator, idx: torch.Tensor) -> torch.Tensor:
        """Angles ~ IGSO3(eps[idx]) by quantile-table lookup."""
        unif = torch.rand(idx.shape, generator=generator, device=self.device)
        return self.quantile_angles(unif, idx)

    def quantile_angles(self, u: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Inverse CDF of IGSO3(eps[idx]) at ``u``."""
        q = self.inv_cdf.shape[-1]
        pos = _quantile_pos(torch.clamp(u, 0.0, 1.0 - 1e-7), q)
        k0 = torch.clamp(torch.floor(pos).long(), max=q - 2)
        frac = pos - k0
        a0 = self.inv_cdf[idx, k0]
        a1 = self.inv_cdf[idx, k0 + 1]
        return a0 + frac * (a1 - a0)

    def cdf_angles(self, theta: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """CDF of IGSO3(eps[idx]) at ``theta``, linear on the cubic grid
        (locs[i] = pi (i/999)^3, so the grid index is closed-form)."""
        n = self.cdf.shape[-1]
        pos = (torch.clamp(theta, 0.0, _PI) / _PI).pow(1.0 / 3.0) * n
        i0 = torch.clamp(torch.floor(pos).long(), 0, n - 1)
        frac = pos - i0
        c_lo = torch.where(
            i0 == 0,
            torch.zeros_like(pos),
            self.cdf[idx, torch.clamp(i0 - 1, min=0)],
        )
        c_hi = self.cdf[idx, i0]
        return c_lo + frac * (c_hi - c_lo)

    def transport_angles(
        self, theta: torch.Tensor, idx_src: torch.Tensor, idx_dst: torch.Tensor
    ) -> torch.Tensor:
        """Exact radial probability-flow map IGSO3(eps[idx_src]) ->
        IGSO3(eps[idx_dst]): theta' = Q_dst(F_src(theta))."""
        return self.quantile_angles(self.cdf_angles(theta, idx_src), idx_dst)

    def sample_angles_exact(self, generator, idx: torch.Tensor, unif=None) -> torch.Tensor:
        """Angles ~ IGSO3(eps[idx]) by the reference's bracketing of the
        full CDF row (a 999-wide gather a sample), from ``unif`` or
        uniforms drawn from ``generator``; the quantile table's reference."""
        return _inverse_cdf_angles(generator, self.trap_locs, self.cdf[idx], unif)

    def sample(self, generator, idx: torch.Tensor) -> torch.Tensor:
        """Rotations ~ IGSO3(eps[idx]), shape (*idx.shape, 3, 3)."""
        angles = self.sample_angles(generator, idx)
        axes = _random_axes(generator, idx.shape, self.device)
        return exp_skewvec(axes * angles[..., None])


@dataclass(frozen=True)
class IsotropicGaussianSO3:
    """IGSO3(eps) about ``mean``, arbitrary-shaped ``eps``; its CDF table is
    built once at construction."""

    eps: torch.Tensor
    mean: torch.Tensor
    trap_locs: torch.Tensor
    cdf: torch.Tensor

    @classmethod
    def create(cls, eps, mean=None, device=None) -> "IsotropicGaussianSO3":
        device = resolve_device(device)
        eps = torch.as_tensor(eps, dtype=torch.float32, device=device)
        if mean is None:
            mean = torch.eye(3, dtype=eps.dtype, device=device)
        locs, cdf = build_cdf(eps)
        return cls(eps=eps, mean=mean, trap_locs=locs, cdf=cdf)

    def sample(self, generator, sample_shape=()) -> torch.Tensor:
        """mean @ exp(uniform axis * inverse-CDF angle)."""
        batch = (*sample_shape, *self.eps.shape)
        rows = self.cdf.expand(*batch, self.cdf.shape[-1])
        angles = _inverse_cdf_angles(generator, self.trap_locs, rows)
        axes = _random_axes(generator, batch, self.eps.device)
        return rmul(self.mean, exp_skewvec(axes * angles[..., None]))

    def log_prob(self, rotations: torch.Tensor) -> torch.Tensor:
        """log f(theta(R)), without the Haar factor, through the fused kernel."""
        angle = rotation_angle(rotations)
        logf, _ = igso3_logpdf_score(angle, self.eps)
        return logf


@dataclass(frozen=True)
class IGSO3xR3:
    """SO(3) x R^3 product: IGSO3(eps) about ``mean.rot`` on the rotation,
    Normal(``mean.shift``, eps * ``shift_scale``) on the shift."""

    igso3: IsotropicGaussianSO3
    mean_shift: torch.Tensor
    shift_scale: float = 1.0

    @classmethod
    def create(cls, eps, mean: AffineT | None = None, shift_scale: float = 1.0,
               device=None) -> "IGSO3xR3":
        device = resolve_device(device)
        eps = torch.as_tensor(eps, dtype=torch.float32, device=device)
        if mean is None:
            mean = AffineT(torch.eye(3, dtype=eps.dtype, device=device),
                           torch.zeros((*eps.shape, 3), dtype=eps.dtype, device=device))
        return cls(igso3=IsotropicGaussianSO3.create(eps, mean.rot, device=device),
                   mean_shift=mean.shift, shift_scale=shift_scale)

    def sample(self, generator, sample_shape=()) -> AffineT:
        """The rotation's draws, then the shift's, from ``generator``."""
        rot = self.igso3.sample(generator, sample_shape)
        eps = self.igso3.eps
        noise = torch.randn((*sample_shape, *eps.shape, 3), generator=generator,
                            device=eps.device, dtype=eps.dtype)
        return AffineT(rot, self.mean_shift + eps[..., None] * self.shift_scale * noise)

    def log_prob(self, value: AffineT) -> torch.Tensor:
        """IGSO(3) log f of the rotation (no Haar factor, through the fused
        kernel) plus the shift's Gaussian log-density."""
        rot_lp = self.igso3.log_prob(value.rot)
        scale = self.igso3.eps[..., None] * self.shift_scale
        z = (value.shift - self.mean_shift) / scale
        shift_lp = torch.sum(-0.5 * z * z - torch.log(scale) - 0.5 * math.log(2 * _PI), dim=-1)
        return rot_lp + shift_lp


@dataclass(frozen=True)
class Bingham:
    """Zero-mean Gaussian on R^4 with its samples L2-normalised onto the
    quaternion 3-sphere.  It keeps the reference's name and semantics: this
    is a projected Gaussian, not a true Bingham density."""

    scale_tril: torch.Tensor  # (4, 4) Cholesky factor of the covariance

    @classmethod
    def create(cls, covariance_matrix, device=None) -> "Bingham":
        """The float32 Cholesky factor, computed on the CPU (so every device
        gets the same factor) and moved to ``device``."""
        cov = torch.as_tensor(np.asarray(covariance_matrix, dtype=np.float32))
        return cls(scale_tril=torch.linalg.cholesky(cov).to(resolve_device(device)))

    def from_normal(self, z: torch.Tensor) -> torch.Tensor:
        """Unit quaternions (..., 4) from standard normal draws ``z`` (..., 4)."""
        vals = torch.matmul(z, self.scale_tril.T)
        return vals / torch.linalg.norm(vals, dim=-1, keepdim=True)

    def sample(self, generator, sample_shape=()) -> torch.Tensor:
        """Unit quaternions (*sample_shape, 4), real part first."""
        z = torch.randn((*sample_shape, 4), generator=generator,
                        device=self.scale_tril.device, dtype=self.scale_tril.dtype)
        return self.from_normal(z)
