"""DDPM on the rotation manifold SO(3) (counterpart of
``diffusion_extensions_tpu/processes/so3.py``).

The IGSO(3) tables for every timestep (forward eps_t = sqrt(1 - acp_t),
reverse sigma_t = posterior stdev, and the eps = 1 prior) are built once in
``SO3Diffusion.create``.  The JAX package's ``lax.scan`` chains are Python
loops here.  Every sampler takes an optional ``x_init`` (skipping its own
init draw) and a ``torch.Generator``; ``p_sample`` also takes an optional
``noise`` rotation so a caller can inject the noise of another run, and the
training losses (``p_losses``, ``loss``) take optional ``t`` and ``noise``
for the same reason.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import obs
from ..ops.igso3 import IGSO3Table, igso3_score_vec
from ..ops.metrics import rmat_dist
from ..ops.so3 import (
    exp_skewvec,
    haar_rotations,
    log_rmat_vec,
    orthogonalise,
    rmul,
    so3_lerp,
    so3_scale,
)
from .schedule import Schedule, extract

__all__ = ["SO3Diffusion", "ProjectedSO3Diffusion", "pf_time_grid", "prefix_products"]


def _linspace_grid(T: int, num_steps: int) -> list[int]:
    """Evenly spaced timestep indices T-1 -> 0 (float32 linspace, rounded
    half to even, as the JAX package rounds them)."""
    grid = torch.linspace(T - 1, 0, num_steps + 1, dtype=torch.float32).round()
    return [int(v) for v in grid.tolist()]


def pf_time_grid(schedule: Schedule, num_steps: int, grid: str = "karras",
                 rho: float = 7.0) -> list[int]:
    """num_steps + 1 timestep indices, descending to 0, for the
    probability-flow samplers: ``"uniform"`` spaces the indices evenly,
    ``"karras"`` spaces the noise levels eps_t by the EDM rho rule."""
    T = schedule.num_timesteps
    if grid == "uniform":
        return _linspace_grid(T, num_steps)
    if grid != "karras":
        raise ValueError(f"Unexpected pf grid: {grid}")
    eps = schedule.sqrt_one_minus_alphas_cumprod.cpu().numpy().astype(np.float64)
    smax, smin = float(eps[T - 1]), float(eps[0])
    u = np.linspace(0.0, 1.0, num_steps + 1)
    sig = (smax ** (1 / rho) + u * (smin ** (1 / rho) - smax ** (1 / rho))) ** rho
    idx = np.clip(np.searchsorted(eps, sig), 0, T - 1)
    # strictly decreasing where possible; the tail is clamped at 0
    for i in range(1, len(idx)):
        idx[i] = min(idx[i], idx[i - 1] - 1)
    idx = np.maximum(idx, 0)
    idx[-1] = 0
    return [int(v) for v in idx]


def prefix_products(m: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products along dim 0, out[i] = m[0] @ m[1] @ ... @
    m[i], by log-depth doubling (Hillis-Steele): ceil(log2 S) rounds of one
    batched 3x3 product each, in true float32."""
    d = 1
    while d < m.shape[0]:
        m = torch.cat((m[:d], rmul(m[:-d], m[d:])), dim=0)
        d *= 2
    return m


@dataclass(frozen=True)
class SO3Diffusion:
    """State = rotation matrices (B, 3, 3); ``denoise_fn(x_in, t) -> (B, 3)``
    skew-vec noise prediction (``loss_type`` "skewvec") or (B, 3, 3)
    rotation ("prevstep")."""

    schedule: Schedule
    q_table: IGSO3Table  # rows: eps_t = sqrt(1 - alphas_cumprod_t)
    p_table: IGSO3Table  # rows: sigma_t = posterior stdev_t
    prior_table: IGSO3Table  # single row: eps = 1
    loss_type: str = "skewvec"
    projected: bool = False  # Haar-QR sampler init instead of the eps = 1 prior

    @classmethod
    def create(
        cls,
        timesteps: int = 1000,
        loss_type: str = "skewvec",
        betas=None,
        projected: bool = False,
        device=None,
    ) -> "SO3Diffusion":
        if loss_type not in ("skewvec", "prevstep"):
            raise ValueError(f"Unexpected loss_type: {loss_type}")
        schedule = Schedule.create(timesteps, betas, device=device)
        q_eps = schedule.sqrt_one_minus_alphas_cumprod.cpu().numpy()
        p_sigma = schedule.posterior_stdev.cpu().numpy()
        dev = schedule.device
        return cls(
            schedule=schedule,
            q_table=IGSO3Table.from_eps(q_eps, dev),
            p_table=IGSO3Table.from_eps(np.maximum(p_sigma, 1e-10), dev),
            prior_table=IGSO3Table.from_eps(np.ones((1,), np.float32), dev),
            loss_type=loss_type,
            projected=projected,
        )

    @property
    def num_timesteps(self) -> int:
        return self.schedule.num_timesteps

    @property
    def device(self) -> torch.device:
        return self.schedule.device

    # -- forward process -------------------------------------------------
    def q_mean_variance(self, x_start, t):
        """Geodesic shrink toward the identity."""
        s = self.schedule
        eye = torch.eye(3, dtype=x_start.dtype, device=x_start.device)
        mean = so3_lerp(eye, x_start, extract(s.sqrt_alphas_cumprod, t, 1))
        variance = extract(1.0 - s.alphas_cumprod, t)
        log_variance = extract(s.log_one_minus_alphas_cumprod, t)
        return mean, variance, log_variance

    def sample_noise(self, generator, t):
        """IGSO3(eps_t) rotation noise from the precomputed table."""
        return self.q_table.sample(generator, t)

    def q_sample(self, x_start, t, noise):
        """so3_scale(x0, sqrt(acp_t)) @ noise."""
        scale = extract(self.schedule.sqrt_alphas_cumprod, t)
        return rmul(so3_scale(x_start, scale), noise)

    def predict_start_from_noise(self, x_t, t, noise_vec):
        """x0 from x_t and the model's skew-vec noise prediction."""
        s = self.schedule
        x_t_term = so3_scale(x_t, extract(s.sqrt_recip_alphas_cumprod, t))
        scaled = noise_vec * extract(s.sqrt_recipm1_alphas_cumprod, t, 1)
        noise_term = exp_skewvec(scaled)
        return rmul(x_t_term, noise_term.transpose(-1, -2))

    def q_posterior(self, x_start, x_t, t):
        s = self.schedule
        c1 = so3_scale(x_start, extract(s.posterior_mean_coef1, t))
        c2 = so3_scale(x_t, extract(s.posterior_mean_coef2, t))
        return (
            rmul(c1, c2),
            extract(s.posterior_variance, t),
            extract(s.posterior_log_variance_clipped, t),
        )

    # -- reverse process -------------------------------------------------
    def p_mean_variance(self, denoise_fn, x, t, projection=None):
        x_in = projection(x) if projection is not None else x
        predict = denoise_fn(x_in, t)
        x_recon = self.predict_start_from_noise(x, t, predict)
        return self.q_posterior(x_recon, x, t)

    def p_sample(self, denoise_fn, generator, x, t, projection=None, noise=None):
        """Posterior mean right-multiplied by IGSO3(sigma_t) noise (drawn
        from ``generator`` unless ``noise`` is given); identity noise at
        t == 0."""
        mean, _, _ = self.p_mean_variance(denoise_fn, x, t, projection)
        if noise is None:
            noise = self.p_table.sample(generator, t)
        eye = torch.eye(3, dtype=x.dtype, device=x.device)
        noise = torch.where((t == 0)[..., None, None], eye, noise)
        return rmul(mean, noise)

    def _init_state(self, generator, shape, x_init, init=None):
        """``x_init``, else ``init``: "qr" (Haar QR) or "igso3" (the eps = 1
        prior); by default "qr" when ``projected``."""
        if x_init is not None:
            return x_init
        if isinstance(shape, int):
            shape = (shape,)
        if init is None:
            init = "qr" if self.projected else "igso3"
        if init not in ("qr", "igso3"):
            raise ValueError(f"Unexpected init: {init}")
        if init == "qr":
            return haar_rotations(generator, (shape[0],), device=self.device)
        zeros = torch.zeros(shape, dtype=torch.long, device=self.device)
        return self.prior_table.sample(generator, zeros)

    def _full_t(self, b: int, value: int) -> torch.Tensor:
        return torch.full((b,), value, dtype=torch.long, device=self.device)

    def p_sample_loop(
        self,
        denoise_fn,
        generator,
        shape,
        projection=None,
        return_trajectory: bool = False,
        x_init=None,
        init=None,
    ):
        """The T-step ancestral chain.  With ``return_trajectory`` also the
        (T, B, 3, 3) states indexed by timestep (the state before that
        timestep's step)."""
        x = self._init_state(generator, shape, x_init, init)
        b = x.shape[0]
        traj = []
        for i in range(self.num_timesteps - 1, -1, -1):
            if return_trajectory:
                traj.append(x)
            x = self.p_sample(denoise_fn, generator, x, self._full_t(b, i), projection)
        if return_trajectory:
            return x, torch.stack(traj[::-1], dim=0)
        return x

    def ddim_sample_loop(
        self,
        denoise_fn,
        generator,
        shape,
        num_steps: int = 50,
        projection=None,
        x_init=None,
        init=None,
    ):
        """Deterministic DDIM on SO(3): ``num_steps`` model evaluations."""
        x = self._init_state(generator, shape, x_init, init)
        b = x.shape[0]
        ts = _linspace_grid(self.num_timesteps, num_steps)
        for i in range(num_steps):
            x = self._ddim_map(
                denoise_fn, x, self._full_t(b, ts[i]), self._full_t(b, ts[i + 1]),
                projection,
            )
        return self._final_estimate(denoise_fn, x, projection)

    def _final_estimate(self, denoise_fn, x, projection):
        """Map the last state to the clean x0 prediction (acp_{-1} = 1)."""
        t0 = self._full_t(x.shape[0], 0)
        x_in = projection(x) if projection is not None else x
        return self.predict_start_from_noise(x, t0, denoise_fn(x_in, t0))

    def _ddim_map(self, denoise_fn, x, t, t_prev, projection=None):
        """One deterministic DDIM step x_t -> x_{t_prev}."""
        s = self.schedule
        x_in = projection(x) if projection is not None else x
        v = denoise_fn(x_in, t)
        x_recon = self.predict_start_from_noise(x, t, v)
        eps_prev = extract(s.sqrt_one_minus_alphas_cumprod, t_prev, 1)
        noise_prev = exp_skewvec(v * eps_prev)
        x_prev = rmul(
            so3_scale(x_recon, extract(s.sqrt_alphas_cumprod, t_prev)), noise_prev
        )
        # duplicated grid points: hold the clean estimate
        return torch.where((t_prev == t)[..., None, None], x_recon, x_prev)

    def _flow_map(self, denoise_fn, x, t, t_prev, projection=None):
        """One exact-transport probability-flow step x_t -> x_{t_prev}."""
        s = self.schedule
        x_in = projection(x) if projection is not None else x
        v = denoise_fn(x_in, t)
        x_recon = self.predict_start_from_noise(x, t, v)
        anchor = so3_scale(x_recon, extract(s.sqrt_alphas_cumprod, t))
        vrel = log_rmat_vec(rmul(anchor.transpose(-1, -2), x))
        theta = torch.linalg.norm(vrel, dim=-1)
        axis = vrel / torch.clamp(theta, min=1e-12)[..., None]
        theta_p = self.q_table.transport_angles(theta, t, t_prev)
        rel_p = exp_skewvec(axis * theta_p[..., None])
        x_new = rmul(so3_scale(x_recon, extract(s.sqrt_alphas_cumprod, t_prev)), rel_p)
        return torch.where((t_prev == t)[..., None, None], x_recon, x_new)

    def pf_sample_loop(
        self,
        denoise_fn,
        generator,
        shape,
        num_steps: int = 50,
        projection=None,
        method: str = "flow",
        grid: str = "karras",
        x_init=None,
        init=None,
    ):
        """Probability-flow (ODE) sampler on SO(3).

        ``method``: "flow" integrates the radial ODE exactly by quantile
        transport (1 model evaluation a step); "euler" (1) and "heun" (2)
        discretise it with the analytic IGSO(3) score ``igso3_score_vec``,
        evaluated at the model's predicted noise rotation, which runs the
        fused CUDA kernel once per evaluation.  ``grid``: see
        ``pf_time_grid``."""
        if method not in ("flow", "euler", "heun"):
            raise ValueError(f"Unexpected pf method: {method}")
        x = self._init_state(generator, shape, x_init, init)
        b = x.shape[0]
        ts = pf_time_grid(self.schedule, num_steps, grid)
        s = self.schedule

        def eval_drift(x, t):
            """Model evaluation -> (x0_hat, Rel, score at N_hat, eps_t)."""
            x_in = projection(x) if projection is not None else x
            v = denoise_fn(x_in, t)
            x_recon = self.predict_start_from_noise(x, t, v)
            anchor = so3_scale(x_recon, extract(s.sqrt_alphas_cumprod, t))
            rel = rmul(anchor.transpose(-1, -2), x)
            eps_t = extract(s.sqrt_one_minus_alphas_cumprod, t)
            n_hat = exp_skewvec(v * eps_t[..., None])
            return x_recon, rel, igso3_score_vec(n_hat, eps_t), eps_t

        for i in range(num_steps):
            t = self._full_t(b, ts[i])
            t_prev = self._full_t(b, ts[i + 1])
            if method == "flow":
                x = self._flow_map(denoise_fn, x, t, t_prev, projection)
                continue
            x_recon, rel, s1, eps_t = eval_drift(x, t)
            eps_p = extract(s.sqrt_one_minus_alphas_cumprod, t_prev)
            dsig = (eps_p - eps_t)[..., None]  # negative: noise shrinks
            u1 = -eps_t[..., None] * s1 * dsig
            acp_prev = extract(s.sqrt_alphas_cumprod, t_prev)
            x_new = rmul(so3_scale(x_recon, acp_prev), rmul(rel, exp_skewvec(u1)))
            if method == "heun":
                x_recon2, _, s2, _ = eval_drift(x_new, t_prev)
                u2 = -eps_p[..., None] * s2 * dsig
                x_new = rmul(
                    so3_scale(x_recon2, acp_prev),
                    rmul(rel, exp_skewvec(0.5 * (u1 + u2))),
                )
            x = torch.where((t_prev == t)[..., None, None], x_recon, x_new)
        return self._final_estimate(denoise_fn, x, projection)

    def parallel_sample_loop(
        self,
        denoise_fn,
        generator,
        shape,
        num_steps: int = 50,
        method: str = "ddim",
        tol: float = 1e-4,
        max_sweeps: int | None = None,
        projection=None,
        grid: str = "karras",
        return_sweeps: bool = False,
        x_init=None,
        init=None,
    ):
        """Parallel-in-time (Picard) sampling of the deterministic reverse
        chain (ParaDiGMS, arXiv:2305.16317, on SO(3)).

        The sequential DDIM ("ddim", ``_ddim_map``, evenly spaced grid) or
        exact-transport probability-flow ("flow", ``_flow_map``, ``grid``)
        chain is a recurrence x_{i+1} = G(x_i, t_i).  Each sweep evaluates G
        at every grid point of the current trajectory guess in one batched
        model call (S x B rows), takes the relative increments
        D_i = x_i^T G(x_i, t_i), and rebuilds the trajectory as
        x_{j+1} = x_0 D_0 ... D_j by a log-depth doubling prefix product
        (``prefix_products``), re-orthogonalised so float32 drift through
        the products never feeds the steep transport map.  It stops when a
        sweep moves no entry by more than ``tol``, or after ``max_sweeps``
        (default S) sweeps.  Sweep k makes the first k + 1 states exact, so
        the fixed point is the sequential chain.

        Returns the clean sample; with ``return_sweeps`` also the number of
        sweeps run.  ``x_init`` skips the sampler's own init draw.
        """
        if method not in ("ddim", "flow"):
            raise ValueError(f"Unexpected parallel method: {method}")
        x0 = self._init_state(generator, shape, x_init, init)
        b = x0.shape[0]
        S = num_steps
        if method == "flow":
            ts = pf_time_grid(self.schedule, S, grid)
        else:
            ts = _linspace_grid(self.num_timesteps, S)
        step_map = self._flow_map if method == "flow" else self._ddim_map
        if max_sweeps is None:
            max_sweeps = S
        grid_t = torch.tensor(ts, dtype=torch.long, device=x0.device)
        t_cur = grid_t[:-1].repeat_interleave(b)  # (S * B,), row s * B + j
        t_prev = grid_t[1:].repeat_interleave(b)

        X = x0[None].expand(S + 1, b, 3, 3)
        diff, k = float("inf"), 0
        while diff > tol and k < max_sweeps:
            xn = step_map(
                denoise_fn, X[:-1].reshape(S * b, 3, 3), t_cur, t_prev, projection
            ).reshape(S, b, 3, 3)
            deltas = rmul(X[:-1].transpose(-1, -2), xn)
            x_new = orthogonalise(rmul(x0[None], prefix_products(deltas)))
            X_new = torch.cat((x0[None], x_new), dim=0)
            diff = float((X_new - X).abs().max())
            X, k = X_new, k + 1
        out = self._final_estimate(denoise_fn, X[-1], projection)
        return (out, k) if return_sweeps else out

    # -- training --------------------------------------------------------
    def p_losses(self, denoise_fn, generator, x_start, t, projection=None, noise=None):
        """The training loss at timesteps ``t`` (uniform on [0, T), drawn
        from ``generator``, when None): "skewvec" is the MSE of the model's
        output against log(noise) / eps_t, "prevstep" the squared
        ``rmat_dist`` of its output rotation to x_noisy^T posterior_mean.
        ``noise`` (B, 3, 3) is drawn from ``generator`` unless given; it
        carries no gradient.  Spans: ``process.noise`` (the draws, q_sample,
        the projection), then ``model.forward`` (the model and the loss)."""
        with obs.span("process.noise"):
            if t is None:
                t = torch.randint(0, self.num_timesteps, (x_start.shape[0],),
                                  generator=generator, device=self.device)
            eps = extract(self.schedule.sqrt_one_minus_alphas_cumprod, t)
            if noise is None:
                noise = self.sample_noise(generator, t)
            noise = noise.detach()
            x_noisy = self.q_sample(x_start, t, noise)
            x_in = projection(x_noisy) if projection is not None else x_noisy
        with obs.span("model.forward"):
            x_recon = denoise_fn(x_in, t)
            if self.loss_type == "skewvec":
                descaled_noise = log_rmat_vec(noise) / eps[..., None]
                return torch.mean((x_recon - descaled_noise) ** 2)
            posterior_mean, _, _ = self.q_posterior(x_start, x_noisy, t)
            step = rmul(x_noisy.transpose(-1, -2), posterior_mean)
            return torch.mean(rmat_dist(x_recon, step) ** 2)

    def loss(self, denoise_fn, generator, x_start, projection=None, t=None, noise=None):
        """``p_losses`` at ``t`` uniform on [0, T), drawn from ``generator``
        unless given."""
        return self.p_losses(denoise_fn, generator, x_start, t, projection, noise)


def ProjectedSO3Diffusion(timesteps: int = 1000, loss_type: str = "skewvec", betas=None,
                          device=None) -> SO3Diffusion:
    """The same process with the projection hook and Haar-QR sampler init."""
    return SO3Diffusion.create(timesteps, loss_type, betas, projected=True, device=device)
