"""Projection operator of the aircraft experiment (counterpart of
``PointCloudProj`` in ``diffusion_extensions_tpu/models/projections.py``)."""
from __future__ import annotations

import torch

__all__ = ["PointCloudProj"]


class PointCloudProj:
    """``data @ R^T``: every point of each cloud rotated by the state's R
    (the SO(3) arm; the Euler arm's angle decoding comes with that arm)."""

    def __init__(self, data: torch.Tensor):
        self.data = data  # (B, N, 3)

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.data, r.transpose(-1, -2))
