"""Diffusion noise schedules (counterpart of
``diffusion_extensions_tpu/processes/schedule.py``).

The buffers are built in numpy float64 exactly as the JAX package builds
them, cast to float32, then moved to the device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device

__all__ = ["cosine_beta_schedule", "Schedule", "extract"]


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    """Cosine beta schedule (Nichol & Dhariwal 2021), float64 on the host."""
    steps = timesteps + 1
    x = np.linspace(0, timesteps, steps, dtype=np.float64)
    alphas_cumprod = np.cos(((x / timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0.0, 0.999)


@dataclass(frozen=True)
class Schedule:
    """All DDPM coefficient tables, shape (T,) each, float32 on ``device``."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor

    @classmethod
    def create(cls, timesteps: int = 1000, betas=None, device=None) -> "Schedule":
        device = resolve_device(device)
        if betas is None:
            betas = cosine_beta_schedule(timesteps)
        betas = np.asarray(betas, dtype=np.float64)
        alphas = 1.0 - betas
        alphas_cumprod = np.cumprod(alphas, axis=0)
        alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
        posterior_variance = (
            betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
        )

        def f32(a):
            return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device)

        return cls(
            betas=f32(betas),
            alphas_cumprod=f32(alphas_cumprod),
            alphas_cumprod_prev=f32(alphas_cumprod_prev),
            sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
            log_one_minus_alphas_cumprod=f32(np.log(1.0 - alphas_cumprod)),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1.0)),
            posterior_variance=f32(posterior_variance),
            posterior_log_variance_clipped=f32(
                np.log(np.maximum(posterior_variance, 1e-20))
            ),
            posterior_mean_coef1=f32(
                betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)
            ),
            posterior_mean_coef2=f32(
                (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)
            ),
        )

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]

    @property
    def device(self) -> torch.device:
        return self.betas.device

    @property
    def posterior_stdev(self) -> torch.Tensor:
        """exp(0.5 * posterior_log_variance_clipped), the reverse-step noise
        scale of the SO(3) samplers."""
        return torch.exp(0.5 * self.posterior_log_variance_clipped)


def extract(a: torch.Tensor, t: torch.Tensor, ndim: int = 0) -> torch.Tensor:
    """Gather coefficients at timesteps ``t`` and append ``ndim`` singleton
    dims (``ndim=0`` returns the batch-shaped gather)."""
    out = a[t]
    return out.reshape(*t.shape, *((1,) * ndim))
