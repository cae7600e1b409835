"""Euler-angle + shift baseline process (counterpart of
``diffusion_extensions_tpu/processes/euler.py``): a Gaussian DDPM on a
6-vector state (3 Euler angles, 3 shift) whose noise is scaled per block,
``rot_scale`` on the angles and ``shift_scale`` on the shift, in the
ancestral steps, in the sampler's init and in the loss.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .r3 import GaussianDiffusion
from .schedule import Schedule, extract

__all__ = ["ProjectedEulerDiffusion"]


@dataclass(frozen=True)
class ProjectedEulerDiffusion(GaussianDiffusion):
    """State (B, 6) = (euler_xyz, shift).  The denoiser predicts unit-scaled
    noise; the block scales live in the process.  Sampling never clips."""

    rot_scale: float = 3.0
    shift_scale: float = 75.0

    @classmethod
    def create(cls, timesteps: int = 1000, loss_type: str = "grad_mse", betas=None,
               rot_scale: float = 3.0, shift_scale: float = 75.0,
               device=None) -> "ProjectedEulerDiffusion":
        if loss_type != "grad_mse":
            raise ValueError(f"Unexpected loss_type: {loss_type}")
        return cls(schedule=Schedule.create(timesteps, betas, device=device),
                   loss_type=loss_type, clip_denoised_default=False,
                   rot_scale=rot_scale, shift_scale=shift_scale)

    def _block_scale(self, dtype=torch.float32) -> torch.Tensor:
        """(rot_scale x 3, shift_scale x 3), filled on the device (no host
        copy: a CUDA graph can capture it)."""
        return torch.cat((torch.full((3,), self.rot_scale, dtype=dtype, device=self.device),
                          torch.full((3,), self.shift_scale, dtype=dtype, device=self.device)))

    def p_sample(self, denoise_fn, generator, x, t, clip_denoised=None, projection=None,
                 noise=None):
        """One ancestral step without clipping; the standard normal ``noise``
        (drawn from ``generator`` unless given) is block-scaled."""
        mean, _, log_var = self.p_mean_variance(denoise_fn, x, t, False, projection)
        if noise is None:
            noise = self._normal(generator, x.shape, x)
        noise = noise * self._block_scale(x.dtype)
        nonzero = 1.0 - (t == 0).to(x.dtype)[..., None]
        return mean + nonzero * torch.exp(0.5 * log_var) * noise

    def _init_state(self, generator, shape, x_init):
        """``x_init``, else a block-scaled standard normal (B, 6)."""
        if x_init is not None:
            return x_init
        b = shape if isinstance(shape, int) else shape[0]
        return self._normal(generator, (b, 6)) * self._block_scale()

    def ddim_sample_loop(self, denoise_fn, generator, shape, num_steps: int = 50,
                         clip_denoised=None, projection=None, x_init=None):
        """DDIM with the inherited R^n jumps (the model output read as the
        base class's noise estimate), no clipping, from the block-scaled
        init of ``p_sample_loop``."""
        return super().ddim_sample_loop(denoise_fn, generator, shape, num_steps, False,
                                        projection, self._init_state(generator, shape, x_init))

    def p_losses(self, denoise_fn, generator, x_start, t, projection=None, noise=None):
        """MSE of the model's output against the unit ``noise``, which
        q_sample sees scaled by the blocks and by sqrt(1 - acp_t), and by
        q_sample's own sqrt(1 - acp_t) again: the reference's double factor
        (its ``diffusion.py:619-621``), kept as it is."""
        if noise is None:
            noise = self._normal(generator, x_start.shape, x_start)
        eps = extract(self.schedule.sqrt_one_minus_alphas_cumprod, t, 1)
        scaled = noise * eps * self._block_scale(noise.dtype)
        x_noisy = self.q_sample(x_start, t, scaled)
        x_in = projection(x_noisy) if projection is not None else x_noisy
        x_recon = denoise_fn(x_in, t)
        return torch.mean((x_recon - noise) ** 2)
