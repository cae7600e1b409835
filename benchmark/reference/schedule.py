"""The cosine noise schedule of the diffusion processes (Nichol & Dhariwal
2021), built in float64 on the host; the tables a reference step reads."""
from __future__ import annotations

import math

import numpy as np
import torch


def cosine_betas(timesteps: int, s: float = 0.008) -> np.ndarray:
    x = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64)
    acp = np.cos(((x / timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
    acp = acp / acp[0]
    return np.clip(1 - acp[1:] / acp[:-1], 0.0, 0.999)


class Schedule:
    """Coefficient tables of T timesteps as float32 tensors on ``device``,
    rounded from float64 once (the precision the processes state)."""

    def __init__(self, timesteps: int, device):
        betas = cosine_betas(timesteps)
        acp = np.cumprod(1.0 - betas)

        def f32(a):
            return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device)

        self.T = timesteps
        self.eps = f32(np.sqrt(1.0 - acp))  # sqrt(1 - acp)
        self.sqrt_acp = f32(np.sqrt(acp))
        self.sqrt_recip_acp = f32(np.sqrt(1.0 / acp))
        self.sqrt_recipm1_acp = f32(np.sqrt(1.0 / acp - 1.0))
        self.eps_np = np.sqrt(1.0 - acp).astype(np.float32)

    def ddim_grid(self, num_steps: int) -> list[int]:
        """num_steps + 1 evenly spaced timesteps T-1 -> 0, rounded half to
        even as float32 values."""
        grid = np.linspace(self.T - 1, 0, num_steps + 1, dtype=np.float32)
        return [int(v) for v in np.round(grid)]
