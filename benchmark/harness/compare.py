"""The numbers that decide ``correct``, each held to a limit of its cell.

Training: each step's loss, the first gradient's norm per leaf and the
norm of each leaf's change over the checked steps, taken by the worst
leaf: |‖program‖ - ‖reference‖| over the larger of the reference's norm of
that leaf and its median leaf's.  Leaves whose reference gradient is under
a thousandth of the median leaf's (a key's bias under softmax: zero in
exact arithmetic) move by rounding alone and are left out of both leaf
numbers, and so are the elements of the others whose reference gradient
is under a thousandth of the median leaf's RMS.  Sampling: the state each step starts from, the denoiser's
output there and the step's result."""
from __future__ import annotations

import math
import statistics

import torch

DEAD_LEAF = 1e-3


def norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def live(ref_grad: dict) -> dict:
    """{leaf: mask of its live elements} over the leaves kept: a leaf
    whose reference gradient norm is under a thousandth of the median
    leaf's is left out, and in the others an element whose reference
    gradient is under a thousandth of the median leaf's RMS (the half of
    a key's weight that reads a token all keys share)."""
    n = norms(ref_grad)
    med = statistics.median(n.values())
    rms = statistics.median(n[k] / math.sqrt(v.numel()) for k, v in ref_grad.items())
    return {k: ref_grad[k].abs() >= DEAD_LEAF * rms for k in ref_grad if n[k] >= DEAD_LEAF * med}


def masked_norms(tree: dict, masks: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(tree[k].to(m.device, torch.float64)[m]))
            for k, m in masks.items()}


def leaf_gap(prog: dict, ref: dict) -> float:
    """The worst leaf's gap of norms; both dicts hold norms."""
    med = statistics.median(ref.values())
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in ref)


def median_diff(prog: dict, ref: dict, masks: dict, prefixes=None) -> float:
    """The median leaf's ||program - reference|| / ||reference|| over its
    live elements: first order in a rounding error, where a gap of norms
    is second order in the part of it orthogonal to the reference."""
    out = []
    for k, m in masks.items():
        if prefixes is not None and not k.startswith(prefixes):
            continue
        r = ref[k].to(torch.float64)[m]
        p = prog[k].to(r.device, torch.float64)[m]
        out.append(float(torch.linalg.vector_norm(p - r) / torch.clamp(torch.linalg.vector_norm(r), min=1e-300)))
    return statistics.median(out)


def loss_gaps(prog: list, ref: list) -> list:
    return [abs(a - b) / abs(b) for a, b in zip(prog, ref)]


def train_numbers(obs: dict, ref: dict, readout=()) -> dict:
    """``obs``: the program's losses, first gradient and change of the
    weights (tensors); ``ref``: ``reference.train.first_steps``;
    ``readout``: the name prefixes of the leaves after the configuration's
    bf16 region, whose gradients see it only through its forward output."""
    masks = live(ref["grad"])
    return {"loss_gap": max(loss_gaps(obs["losses"], ref["losses"])),
            "grad_gap": leaf_gap(masked_norms(obs["grad"], masks), masked_norms(ref["grad"], masks)),
            "delta_gap": leaf_gap(masked_norms(obs["delta"], masks), masked_norms(ref["delta"], masks)),
            "readout_grad_diff": median_diff(obs["grad"], ref["grad"], masks, tuple(readout))}


def judge(numbers: dict, limits: dict) -> bool:
    """Every limited number present, finite and within its limit."""
    return all(k in numbers and numbers[k] == numbers[k] and numbers[k] <= lim
               for k, lim in limits.items())


def report(numbers: dict, limits: dict) -> dict:
    return {k: {"value": numbers.get(k), "limit": lim} for k, lim in limits.items()}
