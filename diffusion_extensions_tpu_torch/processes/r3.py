"""DDPM on R^n (counterpart of ``diffusion_extensions_tpu/processes/r3.py``).

``GaussianDiffusion`` holds the schedule and the loss; the JAX package's
``lax.scan`` chains are Python loops here.  Every sampler takes an optional
``x_init`` (skipping its own init draw) and a ``torch.Generator``;
``p_sample`` and ``p_sample_loop`` also take the standard normal noise of
each step (``noise``), and the training losses (``p_losses``, ``loss``) an
explicit ``t`` and ``noise``, so a caller can replay another run's draws.
``ProjectedGaussianDiffusion`` is the same process with the reference's
projected-subclass defaults: loss l1 and no clipping while sampling.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .schedule import Schedule, extract
from .so3 import _linspace_grid

__all__ = ["GaussianDiffusion", "ProjectedGaussianDiffusion"]


@dataclass(frozen=True)
class GaussianDiffusion:
    """State = any (B, ...) tensor; ``denoise_fn(x_in, t) -> eps_hat`` of the
    state's shape.  ``clip_denoised_default``: whether the samplers clip
    their x0 estimate to [-1, 1] when the caller does not say."""

    schedule: Schedule
    loss_type: str = "l2"
    clip_denoised_default: bool = True

    @classmethod
    def create(cls, timesteps: int = 1000, loss_type: str = "l2", betas=None,
               device=None) -> "GaussianDiffusion":
        if loss_type not in ("l1", "l2"):
            raise ValueError(f"Unexpected loss_type: {loss_type}")
        return cls(schedule=Schedule.create(timesteps, betas, device=device),
                   loss_type=loss_type)

    @property
    def num_timesteps(self) -> int:
        return self.schedule.num_timesteps

    @property
    def device(self) -> torch.device:
        return self.schedule.device

    # -- forward process -------------------------------------------------
    def q_mean_variance(self, x_start, t):
        nd = x_start.dim() - t.dim()
        s = self.schedule
        mean = extract(s.sqrt_alphas_cumprod, t, nd) * x_start
        variance = extract(1.0 - s.alphas_cumprod, t, nd)
        log_variance = extract(s.log_one_minus_alphas_cumprod, t, nd)
        return mean, variance, log_variance

    def q_sample(self, x_start, t, noise):
        nd = x_start.dim() - t.dim()
        s = self.schedule
        return (extract(s.sqrt_alphas_cumprod, t, nd) * x_start
                + extract(s.sqrt_one_minus_alphas_cumprod, t, nd) * noise)

    def predict_start_from_noise(self, x_t, t, noise):
        nd = x_t.dim() - t.dim()
        s = self.schedule
        return (extract(s.sqrt_recip_alphas_cumprod, t, nd) * x_t
                - extract(s.sqrt_recipm1_alphas_cumprod, t, nd) * noise)

    def q_posterior(self, x_start, x_t, t):
        nd = x_t.dim() - t.dim()
        s = self.schedule
        mean = (extract(s.posterior_mean_coef1, t, nd) * x_start
                + extract(s.posterior_mean_coef2, t, nd) * x_t)
        return (mean, extract(s.posterior_variance, t, nd),
                extract(s.posterior_log_variance_clipped, t, nd))

    # -- reverse process -------------------------------------------------
    def _clip(self, clip_denoised) -> bool:
        return self.clip_denoised_default if clip_denoised is None else clip_denoised

    def p_mean_variance(self, denoise_fn, x, t, clip_denoised, projection=None):
        x_in = projection(x) if projection is not None else x
        x_recon = self.predict_start_from_noise(x, t, denoise_fn(x_in, t))
        if clip_denoised:
            x_recon = torch.clamp(x_recon, -1.0, 1.0)
        return self.q_posterior(x_recon, x, t)

    def _normal(self, generator, shape, like=None):
        dtype = torch.float32 if like is None else like.dtype
        return torch.randn(shape, generator=generator, device=self.device, dtype=dtype)

    def p_sample(self, denoise_fn, generator, x, t, clip_denoised=None, projection=None,
                 noise=None):
        """One ancestral step: the posterior mean plus its standard deviation
        times ``noise`` (standard normal, drawn from ``generator`` unless
        given); no noise at t == 0."""
        mean, _, log_var = self.p_mean_variance(denoise_fn, x, t, self._clip(clip_denoised),
                                                projection)
        if noise is None:
            noise = self._normal(generator, x.shape, x)
        nd = x.dim() - t.dim()
        nonzero = 1.0 - (t == 0).to(x.dtype).reshape(*t.shape, *((1,) * nd))
        return mean + nonzero * torch.exp(0.5 * log_var) * noise

    def _init_state(self, generator, shape, x_init):
        return self._normal(generator, shape) if x_init is None else x_init

    def _full_t(self, b: int, value: int) -> torch.Tensor:
        return torch.full((b,), value, dtype=torch.long, device=self.device)

    def p_sample_loop(self, denoise_fn, generator, shape, clip_denoised=None,
                      projection=None, x_init=None, noise=None):
        """The T-step ancestral chain from ``x_init`` (else a standard normal
        draw).  ``noise`` (T, *shape): the standard normal noise of each
        step in the chain's order (``noise[0]`` at t = T - 1)."""
        x = self._init_state(generator, shape, x_init)
        b, T = x.shape[0], self.num_timesteps
        for i in range(T - 1, -1, -1):
            x = self.p_sample(denoise_fn, generator, x, self._full_t(b, i), clip_denoised,
                              projection, None if noise is None else noise[T - 1 - i])
        return x

    def _final_estimate(self, denoise_fn, x, clip_denoised, projection):
        """Map the last state to the clean x0 prediction (acp_{-1} = 1)."""
        t0 = self._full_t(x.shape[0], 0)
        x_in = projection(x) if projection is not None else x
        x = self.predict_start_from_noise(x, t0, denoise_fn(x_in, t0))
        return torch.clamp(x, -1.0, 1.0) if clip_denoised else x

    def _ddim_map(self, denoise_fn, x, t, t_prev, clip_denoised, projection=None):
        """One deterministic DDIM step x_t -> x_{t_prev} (eta = 0), batched
        over the leading dim."""
        s = self.schedule
        nd = x.dim() - 1
        x_in = projection(x) if projection is not None else x
        eps_pred = denoise_fn(x_in, t)
        x_recon = self.predict_start_from_noise(x, t, eps_pred)
        if clip_denoised:
            x_recon = torch.clamp(x_recon, -1.0, 1.0)
        x_prev = (extract(s.sqrt_alphas_cumprod, t_prev, nd) * x_recon
                  + extract(s.sqrt_one_minus_alphas_cumprod, t_prev, nd) * eps_pred)
        # duplicated grid points: hold the clean estimate
        return torch.where((t_prev == t).reshape(-1, *((1,) * nd)), x_recon, x_prev)

    def ddim_sample_loop(self, denoise_fn, generator, shape, num_steps: int = 50,
                         clip_denoised=None, projection=None, x_init=None):
        """Deterministic DDIM: ``num_steps`` model evaluations on an evenly
        spaced grid, then the clean estimate."""
        clip = self._clip(clip_denoised)
        x = self._init_state(generator, shape, x_init)
        b = x.shape[0]
        ts = _linspace_grid(self.num_timesteps, num_steps)
        for i in range(num_steps):
            x = self._ddim_map(denoise_fn, x, self._full_t(b, ts[i]),
                               self._full_t(b, ts[i + 1]), clip, projection)
        return self._final_estimate(denoise_fn, x, clip, projection)

    def parallel_sample_loop(self, denoise_fn, generator, shape, num_steps: int = 50,
                             tol: float = 1e-4, max_sweeps: int | None = None,
                             clip_denoised=None, projection=None,
                             return_sweeps: bool = False, x_init=None):
        """Parallel-in-time (Picard, ParaDiGMS arXiv:2305.16317) DDIM: a sweep
        evaluates the DDIM map at every grid point of the current trajectory
        in one batched model call (S x B rows, row s * B + j) and rebuilds
        the trajectory from the additive increments by prefix sums.  Stops
        when a sweep moves no entry by more than ``tol`` relative to 1 +
        the trajectory's largest entry, or after ``max_sweeps`` (default S);
        the fixed point is ``ddim_sample_loop``."""
        clip = self._clip(clip_denoised)
        x0 = self._init_state(generator, shape, x_init)
        b, S = x0.shape[0], num_steps
        grid = torch.tensor(_linspace_grid(self.num_timesteps, S), dtype=torch.long,
                            device=x0.device)
        t_cur = grid[:-1].repeat_interleave(b)
        t_prev = grid[1:].repeat_interleave(b)
        if max_sweeps is None:
            max_sweeps = S
        X = x0[None].expand(S + 1, *x0.shape)
        diff, k = float("inf"), 0
        while diff > tol and k < max_sweeps:
            xn = self._ddim_map(denoise_fn, X[:-1].reshape(S * b, *x0.shape[1:]), t_cur,
                                t_prev, clip, projection).reshape(S, *x0.shape)
            X_new = torch.cat((x0[None], x0[None] + torch.cumsum(xn - X[:-1], dim=0)), dim=0)
            diff = float((X_new - X).abs().max()) / (1.0 + float(X.abs().max()))
            X, k = X_new, k + 1
        out = self._final_estimate(denoise_fn, X[-1], clip, projection)
        return (out, k) if return_sweeps else out

    def interpolate(self, denoise_fn, generator, x1, x2, t=None, lam: float = 0.5,
                    noise=None):
        """Latent interpolation: noise both ends to step ``t`` (default
        T - 1), mix them by ``lam`` and run the ancestral chain from t - 1
        to 0.  ``noise``: (noise of x1, noise of x2, the chain's step noises
        (t, *x1.shape)), else drawn from ``generator``."""
        b = x1.shape[0]
        t = self.num_timesteps - 1 if t is None else t
        if noise is None:
            noise = (self._normal(generator, x1.shape, x1), self._normal(generator, x2.shape, x2),
                     None)
        n1, n2, chain = noise
        tb = self._full_t(b, t)
        img = (1 - lam) * self.q_sample(x1, tb, n1) + lam * self.q_sample(x2, tb, n2)
        for j, i in enumerate(range(t - 1, -1, -1)):
            img = self.p_sample(denoise_fn, generator, img, self._full_t(b, i),
                                noise=None if chain is None else chain[j])
        return img

    # -- training --------------------------------------------------------
    def p_losses(self, denoise_fn, generator, x_start, t, projection=None, noise=None):
        """l1 or l2 of the model's noise estimate at timesteps ``t``; the
        standard normal ``noise`` is drawn from ``generator`` unless given."""
        if noise is None:
            noise = self._normal(generator, x_start.shape, x_start)
        x_noisy = self.q_sample(x_start, t, noise)
        x_in = projection(x_noisy) if projection is not None else x_noisy
        x_recon = denoise_fn(x_in, t)
        if self.loss_type == "l1":
            return torch.mean(torch.abs(noise - x_recon))
        if self.loss_type == "l2":
            return torch.mean((noise - x_recon) ** 2)
        raise ValueError(f"Unexpected loss_type: {self.loss_type}")

    def loss(self, denoise_fn, generator, x_start, projection=None, t=None, noise=None):
        """``p_losses`` at ``t`` uniform on [0, T), drawn from ``generator``
        unless given."""
        if t is None:
            t = torch.randint(0, self.num_timesteps, (x_start.shape[0],),
                              generator=generator, device=self.device)
        return self.p_losses(denoise_fn, generator, x_start, t, projection, noise)


def ProjectedGaussianDiffusion(timesteps: int = 1000, loss_type: str = "l1", betas=None,
                               device=None) -> GaussianDiffusion:
    """The reference's projected subclass: loss l1, no clipping while
    sampling; pass ``projection=`` to the loss and the samplers."""
    if loss_type not in ("l1", "l2"):
        raise ValueError(f"Unexpected loss_type: {loss_type}")
    return GaussianDiffusion(schedule=Schedule.create(timesteps, betas, device=device),
                             loss_type=loss_type, clip_denoised_default=False)
