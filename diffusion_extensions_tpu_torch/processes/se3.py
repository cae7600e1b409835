"""DDPM on SE(3) = SO(3) x R^3 (counterpart of
``diffusion_extensions_tpu/processes/se3.py``).

The state is an ``AffineT``; rotation noise comes from the same per-timestep
IGSO(3) tables as the SO(3) process, shift noise is Gaussian scaled by
``eps_t * shift_scale``.  ``denoise_fn(x_in, t) -> AffineGrad`` predicts the
unit tangent noise (rot_g, shift_g); the loss is "grad_mse".

As in the JAX package: every sampler starts from AffineT(Haar-QR rotation,
unit Gaussian shift); ``predict_start_from_noise`` removes the shift noise
with its ``shift_scale`` factor (the reference omits it and its sampler
random-walks the shift); ``clip_shift > 0`` clamps the predicted x0 shift
to +-clip_shift in every sampler.  The JAX package's ``lax.scan`` chains
are Python loops here.  Every sampler takes ``x_init`` (skipping its own
init draw), ``p_sample`` takes ``noise``, and ``p_losses`` / ``loss`` take
``t`` and ``noise``, so a caller can feed another run's randomness.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import obs
from ..ops.igso3 import IGSO3Table, igso3_score_vec
from ..ops.se3 import AffineGrad, AffineT, se3_scale
from ..ops.so3 import exp_skewvec, haar_rotations, log_rmat_vec, orthogonalise, rmul, so3_scale
from .schedule import Schedule, extract
from .so3 import _linspace_grid, pf_time_grid, prefix_products

__all__ = ["SE3Diffusion", "ProjectedSE3Diffusion"]

_THETA_MAX = float(np.float32(np.pi - 1e-4))  # the q-table's domain is [0, pi)


def _hold(hold: torch.Tensor, x_recon: AffineT, x_new: AffineT) -> AffineT:
    """x_recon where ``hold`` (duplicated grid points), else x_new."""
    return AffineT(torch.where(hold[..., None, None], x_recon.rot, x_new.rot),
                   torch.where(hold[..., None], x_recon.shift, x_new.shift))


@dataclass(frozen=True)
class SE3Diffusion:
    """State = AffineT; see the module docstring."""

    schedule: Schedule
    q_table: IGSO3Table  # rows: eps_t = sqrt(1 - alphas_cumprod_t)
    p_table: IGSO3Table  # rows: sigma_t = posterior stdev_t
    shift_scale: float = 75.0
    loss_type: str = "grad_mse"
    projected: bool = False
    clip_shift: float = 0.0  # 0 = off (reference parity)

    @classmethod
    def create(cls, timesteps: int = 1000, loss_type: str = "grad_mse", betas=None,
               shift_scale: float = 75.0, projected: bool = False, clip_shift: float = 0.0,
               device=None) -> "SE3Diffusion":
        if loss_type != "grad_mse":
            raise ValueError(f"Unexpected loss_type: {loss_type}")
        schedule = Schedule.create(timesteps, betas, device=device)
        q_eps = schedule.sqrt_one_minus_alphas_cumprod.cpu().numpy()
        p_sigma = schedule.posterior_stdev.cpu().numpy()
        dev = schedule.device
        return cls(
            schedule=schedule,
            q_table=IGSO3Table.from_eps(q_eps, dev),
            p_table=IGSO3Table.from_eps(np.maximum(p_sigma, 1e-10), dev),
            shift_scale=shift_scale,
            loss_type=loss_type,
            projected=projected,
            clip_shift=clip_shift,
        )

    @property
    def num_timesteps(self) -> int:
        return self.schedule.num_timesteps

    @property
    def device(self) -> torch.device:
        return self.schedule.device

    # -- noise -----------------------------------------------------------
    def sample_noise(self, generator, t) -> AffineT:
        """IGSO3(eps_t) rotation and N(0, (eps_t shift_scale)^2) shift."""
        rot = self.q_table.sample(generator, t)
        eps = extract(self.schedule.sqrt_one_minus_alphas_cumprod, t, 1)
        z = torch.randn((*t.shape, 3), generator=generator, device=self.device)
        return AffineT(rot, eps * self.shift_scale * z)

    # -- forward process -------------------------------------------------
    def q_mean_variance(self, x_start: AffineT, t):
        s = self.schedule
        mean = se3_scale(x_start, extract(s.sqrt_alphas_cumprod, t))
        return (mean, extract(1.0 - s.alphas_cumprod, t),
                extract(s.log_one_minus_alphas_cumprod, t))

    def q_sample(self, x_start: AffineT, t, noise: AffineT) -> AffineT:
        """Scale by sqrt(acp_t), then right-compose the rotation noise and
        add the shift noise."""
        x_blend = se3_scale(x_start, extract(self.schedule.sqrt_alphas_cumprod, t))
        return AffineT(rmul(x_blend.rot, noise.rot), x_blend.shift + noise.shift)

    def predict_start_from_noise(self, x_t: AffineT, t, noise: AffineGrad) -> AffineT:
        """x0 from x_t and the predicted unit noise.  The forward chain adds
        eps_t * shift_scale * z and the model predicts z, so the shift term
        is shift_scale * sqrt(1/acp - 1) * z."""
        s = self.schedule
        x_t_term = se3_scale(x_t, extract(s.sqrt_recip_alphas_cumprod, t))
        noise_scale = extract(s.sqrt_recipm1_alphas_cumprod, t, 1)
        noise_rot = exp_skewvec(noise.rot_g * noise_scale)
        noise_shift = noise.shift_g * noise_scale * self.shift_scale
        return AffineT(rmul(x_t_term.rot, noise_rot.transpose(-1, -2)),
                       x_t_term.shift - noise_shift)

    def q_posterior(self, x_start: AffineT, x_t: AffineT, t):
        s = self.schedule
        c1 = se3_scale(x_start, extract(s.posterior_mean_coef1, t))
        c2 = se3_scale(x_t, extract(s.posterior_mean_coef2, t))
        mean = AffineT(rmul(c1.rot, c2.rot), c1.shift + c2.shift)
        return (mean, extract(s.posterior_variance, t),
                extract(s.posterior_log_variance_clipped, t))

    # -- reverse process -------------------------------------------------
    def _clip(self, x_recon: AffineT) -> AffineT:
        if self.clip_shift > 0.0:
            return AffineT(x_recon.rot,
                           torch.clamp(x_recon.shift, -self.clip_shift, self.clip_shift))
        return x_recon

    def _x0_hat(self, denoise_fn, x: AffineT, t, projection):
        """(prediction, clipped x0 estimate) of one model evaluation."""
        x_in = projection(x) if projection is not None else x
        pred: AffineGrad = denoise_fn(x_in, t)
        return pred, self._clip(self.predict_start_from_noise(x, t, pred))

    def p_mean_variance(self, denoise_fn, x: AffineT, t, projection=None):
        _, x_recon = self._x0_hat(denoise_fn, x, t, projection)
        return self.q_posterior(x_recon, x, t)

    def p_sample(self, denoise_fn, generator, x: AffineT, t, projection=None, noise=None):
        """A draw from IGSO3xR3(sigma_t) about the posterior mean: rotation
        right-composed, shift sigma_t * shift_scale * z added; none at
        t == 0.  ``noise``, when given, is AffineT(IGSO3(sigma_t) rotation,
        unit normal z) in place of the generator's draws."""
        mean, _, _ = self.p_mean_variance(denoise_fn, x, t, projection)
        if noise is None:
            rot_noise = self.p_table.sample(generator, t)
            z = torch.randn(mean.shift.shape, generator=generator, device=self.device)
        else:
            rot_noise, z = noise.rot, noise.shift
        at_zero = (t == 0)[..., None]
        eye = torch.eye(3, dtype=x.rot.dtype, device=x.rot.device)
        rot_noise = torch.where(at_zero[..., None], eye, rot_noise)
        sigma = extract(self.schedule.posterior_stdev, t, 1)
        shift_noise = torch.where(at_zero, 0.0, sigma * self.shift_scale * z)
        return AffineT(rmul(mean.rot, rot_noise), mean.shift + shift_noise)

    def _init_state(self, generator, shape, x_init) -> AffineT:
        if x_init is not None:
            return x_init
        b = shape if isinstance(shape, int) else shape[0]
        rot = haar_rotations(generator, (b,), device=self.device)
        return AffineT(rot, torch.randn((b, 3), generator=generator, device=self.device))

    def _full_t(self, b: int, value: int) -> torch.Tensor:
        return torch.full((b,), value, dtype=torch.long, device=self.device)

    def _final_estimate(self, denoise_fn, x: AffineT, projection) -> AffineT:
        """The clean (clipped) x0 prediction at t = 0."""
        return self._x0_hat(denoise_fn, x, self._full_t(len(x.shift), 0), projection)[1]

    def p_sample_loop(self, denoise_fn, generator, shape, projection=None,
                      x_init=None) -> AffineT:
        """The T-step ancestral chain."""
        x = self._init_state(generator, shape, x_init)
        b = len(x.shift)
        for i in range(self.num_timesteps - 1, -1, -1):
            x = self.p_sample(denoise_fn, generator, x, self._full_t(b, i), projection)
        return x

    def _ddim_map(self, denoise_fn, x: AffineT, t, t_prev, projection=None) -> AffineT:
        """One deterministic SE(3) DDIM step x_t -> x_{t_prev}: keep the
        predicted unit noise and jump to the t_prev marginal about the x0
        estimate."""
        s = self.schedule
        pred, x_recon = self._x0_hat(denoise_fn, x, t, projection)
        eps_prev = extract(s.sqrt_one_minus_alphas_cumprod, t_prev, 1)
        rot_prev = rmul(so3_scale(x_recon.rot, extract(s.sqrt_alphas_cumprod, t_prev)),
                        exp_skewvec(pred.rot_g * eps_prev))
        shift_prev = (extract(s.sqrt_alphas_cumprod, t_prev, 1) * x_recon.shift
                      + eps_prev * self.shift_scale * pred.shift_g)
        return _hold(t_prev == t, x_recon, AffineT(rot_prev, shift_prev))

    def ddim_sample_loop(self, denoise_fn, generator, shape, num_steps: int = 50,
                         projection=None, x_init=None) -> AffineT:
        """DDIM on SE(3): ``num_steps`` evaluations on an evenly spaced grid,
        then the clean estimate at t = 0."""
        x = self._init_state(generator, shape, x_init)
        b = len(x.shift)
        ts = _linspace_grid(self.num_timesteps, num_steps)
        for i in range(num_steps):
            x = self._ddim_map(denoise_fn, x, self._full_t(b, ts[i]),
                               self._full_t(b, ts[i + 1]), projection)
        return self._final_estimate(denoise_fn, x, projection)

    def parallel_sample_loop(self, denoise_fn, generator, shape, num_steps: int = 50,
                             tol: float = 1e-4, max_sweeps: int | None = None,
                             projection=None, return_sweeps: bool = False, x_init=None):
        """Parallel-in-time (Picard) SE(3) DDIM: each sweep makes one model
        call over all S grid points (S x B rows, row s * B + j), then
        rebuilds the trajectory from relative increments: rotations by
        prefix products (re-orthogonalised), shifts by prefix sums.  Stops
        when a sweep moves no rotation entry by more than ``tol`` and no
        shift by more than ``tol`` relative to 1 + the largest |shift|, or
        after ``max_sweeps`` (default S).  The fixed point is
        ``ddim_sample_loop``."""
        x0 = self._init_state(generator, shape, x_init)
        b = len(x0.shift)
        S = num_steps
        if max_sweeps is None:
            max_sweeps = S
        grid = torch.tensor(_linspace_grid(self.num_timesteps, S), dtype=torch.long,
                            device=x0.shift.device)
        t_cur = grid[:-1].repeat_interleave(b)  # (S * B,)
        t_prev = grid[1:].repeat_interleave(b)
        rot = x0.rot[None].expand(S + 1, b, 3, 3)
        shift = x0.shift[None].expand(S + 1, b, 3)
        diff, k = float("inf"), 0
        while diff > tol and k < max_sweeps:
            xn = self._ddim_map(
                denoise_fn,
                AffineT(rot[:-1].reshape(S * b, 3, 3), shift[:-1].reshape(S * b, 3)),
                t_cur, t_prev, projection)
            deltas = rmul(rot[:-1].transpose(-1, -2), xn.rot.reshape(S, b, 3, 3))
            rot_new = torch.cat(
                (x0.rot[None], orthogonalise(rmul(x0.rot[None], prefix_products(deltas)))))
            dshift = xn.shift.reshape(S, b, 3) - shift[:-1]
            shift_new = torch.cat((x0.shift[None], x0.shift[None] + torch.cumsum(dshift, 0)))
            shift_mag = 1.0 + shift.abs().max()
            diff = float(torch.maximum((rot_new - rot).abs().max(),
                                       (shift_new - shift).abs().max() / shift_mag))
            rot, shift, k = rot_new, shift_new, k + 1
        out = self._final_estimate(denoise_fn, AffineT(rot[-1], shift[-1]), projection)
        return (out, k) if return_sweeps else out

    def pf_sample_loop(self, denoise_fn, generator, shape, num_steps: int = 50,
                       projection=None, method: str = "flow", grid: str = "karras",
                       x_init=None) -> AffineT:
        """Probability-flow (ODE) sampler on SE(3).

        ``"flow"``: exact transport anchored on the model's prediction: the
        rotation radius eps_t |v_hat| moves by the IGSO(3) quantile
        transport, the shift residual eps_t shift_scale z_hat by the linear
        rescale (1 evaluation a step).  ``"flow-state"`` reads the noise
        block back from the state instead (log(anchor^-1 x), the shift
        residual), the JAX package's earlier variant.  ``"euler"`` (1) and
        ``"heun"`` (2 evaluations) discretise the score ODE: the rotation
        score is ``igso3_score_vec`` at the predicted noise rotation (one
        launch of the IGSO(3) kernel per evaluation on the card), the shift
        score the Gaussian one.  ``grid``: see ``pf_time_grid``."""
        if method not in ("flow", "flow-state", "euler", "heun"):
            raise ValueError(f"Unexpected pf method: {method}")
        x = self._init_state(generator, shape, x_init)
        b = len(x.shift)
        ts = pf_time_grid(self.schedule, num_steps, grid)
        s = self.schedule
        scale = self.shift_scale

        def eval_drift(x: AffineT, t):
            """Scores at the model's predicted noise: (x0_hat, Rel,
            rotation score, shift score, eps_t)."""
            pred, x_recon = self._x0_hat(denoise_fn, x, t, projection)
            acp = extract(s.sqrt_alphas_cumprod, t)
            eps_t = extract(s.sqrt_one_minus_alphas_cumprod, t)
            rel = rmul(so3_scale(x_recon.rot, acp).transpose(-1, -2), x.rot)
            rot_score = igso3_score_vec(exp_skewvec(pred.rot_g * eps_t[..., None]), eps_t)
            sigma_sh = eps_t[..., None] * scale
            shift_score = -(sigma_sh * pred.shift_g) / torch.clamp(sigma_sh**2, min=1e-20)
            return x_recon, rel, rot_score, shift_score, eps_t

        def assemble(x_recon: AffineT, rel_new, shift_resid_new, t_prev) -> AffineT:
            acp_prev = extract(s.sqrt_alphas_cumprod, t_prev)
            return AffineT(rmul(so3_scale(x_recon.rot, acp_prev), rel_new),
                           acp_prev[..., None] * x_recon.shift + shift_resid_new)

        def flow_step(x: AffineT, t, t_prev) -> AffineT:
            pred, x_recon = self._x0_hat(denoise_fn, x, t, projection)
            acp = extract(s.sqrt_alphas_cumprod, t)
            eps_t = extract(s.sqrt_one_minus_alphas_cumprod, t)
            eps_p = extract(s.sqrt_one_minus_alphas_cumprod, t_prev)
            if method == "flow-state":
                anchor = so3_scale(x_recon.rot, acp)
                vrel = log_rmat_vec(rmul(anchor.transpose(-1, -2), x.rot))
                resid = x.shift - acp[..., None] * x_recon.shift
                resid_p = resid * (eps_p / torch.clamp(eps_t, min=1e-12))[..., None]
            else:
                vrel = pred.rot_g * eps_t[..., None]
                resid_p = (eps_p[..., None] * scale) * pred.shift_g
            theta = torch.linalg.norm(vrel, dim=-1)
            axis = vrel / torch.clamp(theta, min=1e-12)[..., None]
            theta = torch.clamp(theta, max=_THETA_MAX)
            theta_p = self.q_table.transport_angles(theta, t, t_prev)
            rel_p = exp_skewvec(axis * theta_p[..., None])
            return _hold(t_prev == t, x_recon, assemble(x_recon, rel_p, resid_p, t_prev))

        def ode_step(x: AffineT, t, t_prev) -> AffineT:
            x_recon, rel, rs1, ss1, eps_t = eval_drift(x, t)
            eps_p = extract(s.sqrt_one_minus_alphas_cumprod, t_prev)
            dsig = (eps_p - eps_t)[..., None]  # noise-coordinate step (< 0)
            u1 = -eps_t[..., None] * rs1 * dsig
            # the shift integrates in sigma_sh = eps * shift_scale coordinates
            acp = extract(s.sqrt_alphas_cumprod, t)
            resid = x.shift - acp[..., None] * x_recon.shift
            v1 = -(eps_t[..., None] * scale) * ss1 * (dsig * scale)
            x_new = assemble(x_recon, rmul(rel, exp_skewvec(u1)), resid + v1, t_prev)
            if method == "heun":
                x_recon2, _, rs2, ss2, _ = eval_drift(x_new, t_prev)
                u2 = -eps_p[..., None] * rs2 * dsig
                v2 = -(eps_p[..., None] * scale) * ss2 * (dsig * scale)
                x_new = assemble(x_recon2, rmul(rel, exp_skewvec(0.5 * (u1 + u2))),
                                 resid + 0.5 * (v1 + v2), t_prev)
            return _hold(t_prev == t, x_recon, x_new)

        step = flow_step if method in ("flow", "flow-state") else ode_step
        for i in range(num_steps):
            x = step(x, self._full_t(b, ts[i]), self._full_t(b, ts[i + 1]))
        return self._final_estimate(denoise_fn, x, projection)

    # -- training --------------------------------------------------------
    def p_losses(self, denoise_fn, generator, x_start: AffineT, t, projection=None,
                 noise: AffineT | None = None):
        """grad_mse: the MSE of the predicted shift against noise.shift /
        (eps_t shift_scale) plus that of the predicted rot_g against
        log(noise.rot) / eps_t.  ``t`` is drawn uniform on [0, T) from
        ``generator`` when None, ``noise`` unless given; it carries no
        gradient.  Spans: ``process.noise`` (the draws, q_sample, the
        projection), then ``model.forward`` (the model and the loss)."""
        with obs.span("process.noise"):
            if t is None:
                t = torch.randint(0, self.num_timesteps, (len(x_start.shift),),
                                  generator=generator, device=self.device)
            eps = extract(self.schedule.sqrt_one_minus_alphas_cumprod, t, 1)
            if noise is None:
                noise = self.sample_noise(generator, t)
            noise = AffineT(noise.rot.detach(), noise.shift.detach())
            x_noisy = self.q_sample(x_start, t, noise)
            x_in = projection(x_noisy) if projection is not None else x_noisy
        with obs.span("model.forward"):
            x_recon: AffineGrad = denoise_fn(x_in, t)
            descaled_shift = noise.shift / (eps * self.shift_scale)
            descaled_rot = log_rmat_vec(noise.rot) / eps
            loss_shift = torch.mean((x_recon.shift_g - descaled_shift) ** 2)
            loss_rot = torch.mean((x_recon.rot_g - descaled_rot) ** 2)
            return loss_shift + loss_rot

    def loss(self, denoise_fn, generator, x_start: AffineT, projection=None, t=None,
             noise=None):
        """``p_losses`` at ``t`` uniform on [0, T), drawn from ``generator``
        unless given."""
        return self.p_losses(denoise_fn, generator, x_start, t, projection, noise)


def ProjectedSE3Diffusion(timesteps: int = 1000, loss_type: str = "grad_mse", betas=None,
                          shift_scale: float = 75.0, clip_shift: float = 0.0,
                          device=None) -> SE3Diffusion:
    """The process with the projection hook (the JAX package's factory)."""
    return SE3Diffusion.create(timesteps, loss_type, betas, shift_scale, projected=True,
                               clip_shift=clip_shift, device=device)
