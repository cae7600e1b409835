"""Seeds, clocks and batch trees."""
from __future__ import annotations

import time

import numpy as np
import torch

# what each seed drawn from --seed is for
WEIGHTS, DATA, GENERATOR, CHECK, CALL, WARMUP = 1, 2, 3, 4, 5, 6


def derive(seed: int, *tags: int) -> int:
    """A seed for one purpose, from --seed (any whole number) and tags;
    below 2**63, as ``torch.Generator.manual_seed`` takes it."""
    state = np.random.SeedSequence([seed % 2 ** 64, *tags]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng(derive(seed, *tags))


def tree_map(fn, batch):
    """``fn`` on every tensor of a tensor / (named) tuple / dict tree."""
    if isinstance(batch, torch.Tensor):
        return fn(batch)
    if isinstance(batch, dict):
        return {k: tree_map(fn, v) for k, v in batch.items()}
    if hasattr(batch, "_fields"):
        return type(batch)(*(tree_map(fn, v) for v in batch))
    return type(batch)(tree_map(fn, v) for v in batch)


class Clock:
    """Seconds a phase of set-up takes: ``mark(name)`` closes the phase
    that started at the last mark (or at ``t0``)."""

    def __init__(self, t0: float | None = None):
        self.last = time.perf_counter() if t0 is None else t0
        self.phases = {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.phases[name] = now - self.last
        self.last = now


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Marks:
    """Points in the stream of work: CUDA events on the card, on which the
    host waits to run at most one call ahead."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def wait(self, i: int) -> None:
        """Until mark ``i`` has passed (bounds how far the host runs ahead)."""
        if self.cuda and 0 <= i < len(self.marks):
            self.marks[i].synchronize()
