"""PlaneNet's forward."""
from __future__ import annotations

DIM_FEEDFORWARD = 2048


def forward(dim: int, layers: int, batch: int, points: int, dff: int = DIM_FEEDFORWARD) -> float:
    """Per token the SIREN (3 -> dim/2, dim/2 -> dim/2) and the pool's
    value and gate; per layer and token q / k / v / out, the feed-forward
    pair, QK^T and AV over all points; per cloud the head."""
    half = dim // 2
    tokens = batch * points
    per_token = 2 * (3 * half + half * half) + 2 * (dim + dim * dim)
    per_token += layers * (2 * 4 * dim * dim + 4 * points * dim + 2 * 2 * dim * dff)
    return float(per_token * tokens + 2 * 3 * dim * batch)
