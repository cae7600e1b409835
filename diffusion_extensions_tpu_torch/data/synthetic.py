"""Bingham covariance presets (counterpart of the Bingham part of
``diffusion_extensions_tpu/data/synthetic.py``; the reference's
``bingham_train.py:54-78``): the port's own numpy copy."""
from __future__ import annotations

import numpy as np

from ..ops.igso3 import Bingham

__all__ = ["BINGHAM_COVS", "BINGHAM_TITLES", "bingham_dist"]

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
