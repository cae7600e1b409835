"""The first steps of training, as the reference computes them: the
loss of each step, the first step's gradient and the weights' change."""
from __future__ import annotations

import torch

from .adam import Adam


def first_steps(loss_fn, weights: dict, batches: list, draw, lr: float, dtype=torch.float64) -> dict:
    """``len(batches)`` Adam steps from ``weights`` (not changed).
    ``loss_fn(params, batch, draw_out) -> scalar``, ``draw()`` one step's
    randomness.  Returns the losses, the first gradient and the change of
    each leaf over all the steps."""
    params = {k: v.detach().to(dtype).clone() for k, v in weights.items()}
    opt = Adam(params, lr)
    losses, first = [], None
    for batch in batches:
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        loss = loss_fn(leaves, batch, draw())
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        for v in params.values():
            v.requires_grad_(False)
        losses.append(float(loss.detach()))
        if first is None:
            first = grads
        opt.step(grads)
    delta = {k: params[k] - weights[k].to(dtype) for k in params}
    return {"losses": losses, "grad": first, "delta": delta}
