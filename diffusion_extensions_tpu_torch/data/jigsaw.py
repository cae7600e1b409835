"""The jigsaw translation toy's puzzle and its renderer (counterpart of
``diffusion_extensions_tpu/data/jigsaw.py``).

A red square and a blue circle at random positions (the circle within
+-circle_size/2 of the square's centre), the circle's true position cut out
in white.  The diffusion state (..., 2) is the moving circle's position,
mapped to pixels by ``pix = size * x / 8 + size / 2`` (the image is eight
standard deviations wide).

``render_jigsaw`` is plain tensor arithmetic on the state's device,
vectorised over the batch: inside a train step it is the projection, so
there is no host rendering loop.  Images are NCHW, (..., 3, size, size):
the JAX package's NHWC images with the channel axis moved, so the first
spatial axis is the x pixel there as here.  ``JigsawPuzzle`` draws its
positions from ``np.random.default_rng(seed)`` as the JAX class does, so a
seed gives the same puzzle in both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device

__all__ = ["JigsawPuzzle", "render_jigsaw", "puzzle_rows"]

_RED = (1.0, 0.0, 0.0)
_BLUE = (0.0, 0.0, 1.0)
_WHITE = (1.0, 1.0, 1.0)


def _color(rgb, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(rgb, dtype=like.dtype, device=like.device)[:, None, None]


def render_jigsaw(
    circ_positions: torch.Tensor,
    square_pos: torch.Tensor,
    circle_true: torch.Tensor,
    size: int = 128,
    square_size: int = 32,
    circle_size: int = 32,
) -> torch.Tensor:
    """(..., 2) state -> (..., 3, size, size) images of the state's dtype;
    ``square_pos`` and ``circle_true`` are (2,) pixel positions on the
    state's device."""
    device = circ_positions.device
    pix = size * circ_positions / 8.0 + size / 2.0
    batch_shape = pix.shape[:-1]
    flat = pix.reshape(-1, 2)

    gx = torch.arange(size, dtype=torch.float32, device=device)[:, None]
    gy = torch.arange(size, dtype=torch.float32, device=device)[None, :]
    half_sq = square_size / 2.0
    half_c = circle_size / 2.0
    red, blue, white = (_color(c, pix) for c in (_RED, _BLUE, _WHITE))

    in_square = (torch.abs(gx - square_pos[0]) <= half_sq) & (
        torch.abs(gy - square_pos[1]) <= half_sq)
    d_true = torch.hypot(gx - circle_true[0], gy - circle_true[1])
    base = torch.where(in_square, red, white)
    base = torch.where(d_true <= half_c, white, base)

    d_circ = torch.hypot(gx[None] - flat[:, 0, None, None], gy[None] - flat[:, 1, None, None])
    imgs = torch.where((d_circ <= half_c)[:, None], blue[None], base[None])
    return imgs.reshape(*batch_shape, 3, size, size)


class JigsawPuzzle:
    """One puzzle (a fixed square and true circle position), callable as a
    process ``projection``: (B, 2) -> (B, 3, size, size) on the state's
    device.  ``square_pos`` and ``circle_pos`` are integer pixel positions,
    ``x_0`` the solution in state space, all numpy on the host."""

    def __init__(self, size=128, square_size=32, circle_size=32, seed=None):
        self.size = size
        self.circle_size = circle_size
        self.square_size = square_size
        rng = np.random.default_rng(seed=seed)
        lo = (circle_size + square_size) // 2
        hi = size - lo
        self.square_pos = rng.integers(lo, hi, size=2)
        self.circle_pos = (rng.integers(-circle_size // 2, circle_size // 2, size=2)
                           + self.square_pos)
        self.x_0 = ((self.circle_pos - size / 2) * 8.0 / size).astype(np.float32)
        self._on = {}  # device -> (square_pos, circle_pos) tensors

    def positions(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """(square_pos, circle_pos) as float32 tensors on ``device``, made once."""
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = tuple(torch.tensor(p, dtype=torch.float32, device=device)
                                     for p in (self.square_pos, self.circle_pos))
        return self._on[device]

    def draw_true(self, device=None) -> torch.Tensor:
        """The solved puzzle (3, size, size): the circle drawn blue at its
        true position, the cut-out moved far off the image."""
        device = resolve_device(device)
        square, _ = self.positions(device)
        return render_jigsaw(
            torch.tensor(self.x_0[None], device=device), square,
            torch.tensor([-1e6, -1e6], dtype=torch.float32, device=device),
            self.size, self.square_size, self.circle_size)[0]

    def __call__(self, circ_positions: torch.Tensor) -> torch.Tensor:
        square, circle = self.positions(circ_positions.device)
        return render_jigsaw(circ_positions, square, circle, self.size, self.square_size,
                             self.circle_size)


def puzzle_rows(seeds, size: int = 128) -> np.ndarray:
    """(n, 6) float32: square_pos, circle_pos and x_0 of the puzzle of each
    seed, so a block of training steps' puzzles reaches the device in one
    copy."""
    rows = np.empty((len(seeds), 6), np.float32)
    for r, seed in enumerate(seeds):
        jp = JigsawPuzzle(size=size, seed=seed)
        rows[r] = np.concatenate((jp.square_pos, jp.circle_pos, jp.x_0))
    return rows
