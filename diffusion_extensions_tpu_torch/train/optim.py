"""Optimizer factory shared by the experiment drivers (counterpart of
``diffusion_extensions_tpu/train/optim.py``).

Adam with two opt-in stabilizers, global-norm gradient clipping (``--clip``)
and cosine decay of the learning rate to ``final_frac * lr`` over
``--steps`` (``--lr-schedule cosine``), in two implementations of the same
arithmetic:

* ``impl="optax"`` (the flag value keeps the JAX package's name): the plain
  chain, one pass per transformation and per leaf, rounding as
  ``optax.chain(clip_by_global_norm(clip), adam(lr))`` does: gradients are
  left alone when their norm is under ``clip`` and scaled by ``clip / norm``
  otherwise; ``(mu / bc1) / (sqrt(nu / bc2) + eps) * -lr``;
* ``impl="fused"``: the one-expression-per-leaf update of the JAX package's
  ``fused_adam`` over all leaves at once with ``torch._foreach_*``: the clip
  is the scalar ``min(1, clip / max(norm, 1e-12))`` folded into the gradient,
  the update ``-lr * (mu / bc1) / (sqrt(nu / bc2) + eps)``.
  ``state_dtype="bf16"`` stores both moments in bf16; they are cast up to
  float32 before the update and down after it.

Both evaluate the schedule at the pre-increment count (step 0 uses
``schedule(0)``) and the bias corrections at the post-increment count.  The
count and every scalar derived from it are tensors on the parameters'
device, so a step never waits for the device.
"""
from __future__ import annotations

import math
from typing import Iterable

import torch

__all__ = ["Adam", "make_optimizer", "add_optim_flags", "global_norm"]

_STATE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares over every tensor), a float32 scalar tensor."""
    norms = torch.stack(torch._foreach_norm(tensors)).float()
    return torch.sqrt(torch.sum(norms * norms))


class Adam:
    """Adam over named parameters; see the module docstring.  ``step()``
    reads each parameter's ``.grad`` and updates the parameter in place."""

    def __init__(self, named_params, lr: float, clip: float, schedule: str,
                 total_steps: int | None, final_frac: float, impl: str,
                 state_dtype: torch.dtype, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.names, self.params = [], []
        for name, p in named_params:
            self.names.append(name)
            self.params.append(p)
        if not self.params:
            raise ValueError("optimizer got no parameters")
        self.lr, self.clip, self.schedule = lr, clip, schedule
        self.total_steps, self.final_frac = total_steps, final_frac
        self.impl, self.state_dtype = impl, state_dtype
        self.b1, self.b2, self.eps = b1, b2, eps
        device = self.params[0].device
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        self.mu = [torch.zeros_like(p, dtype=state_dtype) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=state_dtype) for p in self.params]

    def learning_rate(self, count) -> torch.Tensor:
        """The schedule at ``count`` (an int or a tensor): a float32 tensor."""
        c = torch.as_tensor(count, device=self.count.device).to(torch.float32)
        if self.schedule == "const":
            return torch.full_like(c, self.lr)
        total = float(self.total_steps)
        c = torch.clamp(c, max=total)
        cosine = 0.5 * (1.0 + torch.cos(math.pi * c / total))
        return self.lr * ((1.0 - self.final_frac) * cosine + self.final_frac)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        grads = []
        for name, p in zip(self.names, self.params):
            if p.grad is None:
                raise RuntimeError(f"parameter {name} has no gradient")
            grads.append(p.grad)
        lr_t = self.learning_rate(self.count)
        self.count += 1
        cf = self.count.to(torch.float32)
        bc1 = 1.0 - self.b1 ** cf
        bc2 = 1.0 - self.b2 ** cf
        if self.impl == "fused":
            self._fused(grads, lr_t, bc1, bc2)
        else:
            self._chain(grads, lr_t, bc1, bc2)

    def _chain(self, grads, lr_t, bc1, bc2) -> None:
        b1, b2 = self.b1, self.b2
        if self.clip and self.clip > 0:
            norm = global_norm(grads)
            under = norm < self.clip
            grads = [torch.where(under, g, (g / norm) * self.clip) for g in grads]
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1.0 - b1) * g + b1 * mu)
            nu.copy_((1.0 - b2) * (g * g) + b2 * nu)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.add_(update * -lr_t)

    def _fused(self, grads, lr_t, bc1, bc2) -> None:
        b1, b2 = self.b1, self.b2
        if self.clip and self.clip > 0:
            scale = torch.clamp(self.clip / torch.clamp(global_norm(grads), min=1e-12), max=1.0)
            grads = torch._foreach_mul(grads, scale)
        compressed = self.state_dtype != torch.float32
        mu = [m.float() for m in self.mu] if compressed else self.mu
        nu = [n.float() for n in self.nu] if compressed else self.nu
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
        update = torch._foreach_div(mu, bc1)
        torch._foreach_mul_(update, -lr_t)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(update, denom)
        torch._foreach_add_(self.params, update)
        if compressed:
            torch._foreach_copy_(self.mu, mu)
            torch._foreach_copy_(self.nu, nu)

    def state_dict(self) -> dict:
        return {"count": self.count.clone(),
                "mu": {n: m.clone() for n, m in zip(self.names, self.mu)},
                "nu": {n: v.clone() for n, v in zip(self.names, self.nu)}}

    def load_state_dict(self, state: dict) -> None:
        """Copy ``state`` (of ``state_dict``, or of
        ``convert.adam_state_from_optax``) in; names, shapes and the moments'
        dtype must match this optimizer's."""
        for key, mine in (("mu", self.mu), ("nu", self.nu)):
            stored = state[key]
            if sorted(stored) != sorted(self.names):
                raise ValueError(
                    f"optimizer state {key}: stored names do not match the model's "
                    f"(missing {sorted(set(self.names) - set(stored))}, "
                    f"extra {sorted(set(stored) - set(self.names))})")
            for name, dst in zip(self.names, mine):
                src = stored[name]
                if src.shape != dst.shape or src.dtype != dst.dtype:
                    raise ValueError(
                        f"optimizer state {key}[{name}]: stored {tuple(src.shape)} "
                        f"{src.dtype} vs optimizer {tuple(dst.shape)} {dst.dtype} "
                        "(resume with the same --opt-state-dtype)")
                dst.copy_(src)
        self.count.copy_(torch.as_tensor(state["count"]))


def make_optimizer(
    params: Iterable,
    lr: float,
    clip: float = 0.0,
    schedule: str = "const",
    total_steps: int | None = None,
    final_frac: float = 0.1,
    impl: str = "optax",
    state_dtype: str = "f32",
) -> Adam:
    """Adam over ``params`` (``model.named_parameters()``) with optional
    global-norm clipping and cosine decay of the learning rate.

    ``impl="fused"`` is the same arithmetic in one ``torch._foreach_*`` sweep
    over all leaves.  ``state_dtype="bf16"`` stores the moments compressed
    (the update still runs in float32); it needs the fused implementation
    and is opt-in, never a default."""
    if schedule == "cosine":
        if not total_steps:
            raise ValueError("cosine schedule needs total_steps")
    elif schedule != "const":
        raise ValueError(f"unknown lr schedule: {schedule!r}")
    if state_dtype not in _STATE_DTYPES:
        raise ValueError(f"unknown opt state dtype: {state_dtype!r}")
    if state_dtype == "bf16" and impl != "fused":
        raise ValueError("--opt-state-dtype bf16 requires --opt-impl fused")
    if impl not in ("optax", "fused"):
        raise ValueError(f"unknown optimizer impl: {impl!r}")
    return Adam(params, lr, clip, schedule, total_steps, final_frac, impl,
                _STATE_DTYPES[state_dtype])


def add_optim_flags(parser) -> None:
    """Attach the shared ``--clip`` / ``--lr-schedule`` / ``--opt-impl`` /
    ``--opt-state-dtype`` flags."""
    parser.add_argument(
        "--clip", type=float, default=0.0,
        help="global-norm gradient clip before Adam (0 = off, the "
             "reference protocol)",
    )
    parser.add_argument(
        "--lr-schedule", dest="lr_schedule",
        choices=("const", "cosine"), default="const",
        help="LR schedule: const (reference protocol) or cosine decay "
             "to 0.1*lr over --steps",
    )
    parser.add_argument(
        "--opt-impl", dest="opt_impl", choices=("optax", "fused"),
        default="optax",
        help="Adam implementation: optax (the plain chain, one pass per "
             "transformation) or fused (same math, one torch._foreach sweep)",
    )
    parser.add_argument(
        "--opt-state-dtype", dest="opt_state_dtype",
        choices=("f32", "bf16"), default="f32",
        help="Adam moment storage dtype (bf16 halves the moments' memory "
             "traffic; needs --opt-impl fused; resume with the same dtype)",
    )
