"""Synthetic targets of the toy experiments (counterpart of
``diffusion_extensions_tpu/data/synthetic.py``; the port's own copy):

* two-mode rotations: +-90 deg about z (the reference's ``so3_train.py:65-68``);
* the gimbal-lock segment: so3_lerp between R(0, pi/3, 0) and R(0, 2pi/3, 0)
  (``so3_lock_train.py:76-81``);
* the Bingham covariance presets sur / scr / lcr / lur
  (``bingham_train.py:54-78``).

The samplers draw from an explicit ``torch.Generator`` on its device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.igso3 import Bingham
from ..ops.so3 import euler_to_rmat, so3_lerp

__all__ = [
    "two_mode_rotations",
    "sample_two_mode_batch",
    "lock_segment_endpoints",
    "sample_lock_batch",
    "BINGHAM_COVS",
    "BINGHAM_TITLES",
    "bingham_dist",
]


def two_mode_rotations(device=None) -> torch.Tensor:
    """(2, 3, 3): the rotations by +90 and -90 deg about z."""
    z90 = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], device=device)
    return torch.stack((z90, z90.T), dim=0)


def sample_two_mode_batch(generator: torch.Generator, batch: int) -> torch.Tensor:
    """(batch, 3, 3): each row one of the two modes, uniformly."""
    idx = torch.randint(0, 2, (batch,), generator=generator, device=generator.device)
    return two_mode_rotations(generator.device)[idx]


def lock_segment_endpoints(device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """R(0, pi/3, 0) and R(0, 2pi/3, 0), each (1, 3, 3)."""
    zero = torch.zeros((), device=device)
    r1 = euler_to_rmat(zero, torch.full((), math.pi / 3, device=device), zero)[None]
    r2 = euler_to_rmat(zero, torch.full((), 2 * math.pi / 3, device=device), zero)[None]
    return r1, r2


def sample_lock_batch(generator: torch.Generator, batch: int) -> torch.Tensor:
    """(batch, 3, 3): uniform points of the geodesic segment between the
    two endpoints, which crosses the gimbal lock at |y| = pi/2."""
    r1, r2 = lock_segment_endpoints(generator.device)
    weight = torch.rand((batch, 1), generator=generator, device=generator.device)
    return so3_lerp(r1, r2, weight)


BINGHAM_COVS: dict[str, np.ndarray] = {
    "sur": np.diag([1000.0, 0.1, 0.1, 0.1]).astype(np.float32),
    "scr": np.array(
        [
            [1e05, 0.00, 0.00, 0.00],
            [0.00, 1.00, 0.99, 0.99],
            [0.00, 0.99, 1.00, 0.99],
            [0.00, 0.99, 0.99, 1.00],
        ],
        dtype=np.float32,
    ),
    "lcr": np.array(
        [
            [1.00, 0.00, 0.00, 0.00],
            [0.00, 1.00, 0.90, 0.90],
            [0.00, 0.90, 1.00, 0.90],
            [0.00, 0.90, 0.90, 1.00],
        ],
        dtype=np.float32,
    ),
    "lur": np.eye(4, dtype=np.float32),
}

BINGHAM_TITLES = {
    "sur": "Small Uncorrelated Rotations",
    "scr": "Small Correlated Rotations",
    "lcr": "Large Correlated Rotations",
    "lur": "Large Uncorrelated Rotations",
}


def bingham_dist(acro: str, device=None) -> Bingham:
    return Bingham.create(BINGHAM_COVS[acro], device=device)
