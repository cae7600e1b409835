"""Optimizer factory shared by the experiment drivers (counterpart of
``diffusion_extensions_tpu/train/optim.py``).

Adam with two opt-in stabilizers, global-norm gradient clipping (``--clip``)
and cosine decay of the learning rate to ``final_frac * lr`` over
``--steps`` (``--lr-schedule cosine``), in two orders of the same
arithmetic (``impl``):

* ``impl="optax"`` (the flag value keeps the JAX package's name): the plain
  chain, rounding as ``optax.chain(clip_by_global_norm(clip), adam(lr))``
  does: gradients are left alone when their norm is under ``clip`` and
  scaled by ``clip / norm`` otherwise; ``(mu / bc1) / (sqrt(nu / bc2) + eps)
  * -lr``;
* ``impl="fused"``: the JAX package's ``fused_adam``, rounding as one
  ``torch._foreach_*`` sweep over all leaves: the clip is the scalar
  ``min(1, clip / max(norm, 1e-12))`` folded into the gradient, the update
  ``-lr * (mu / bc1) / (sqrt(nu / bc2) + eps)``.
  ``state_dtype="bf16"`` stores both moments in bf16; the update reads and
  computes them in float32 and rounds them to bf16 at the store.

``step()`` computes the step's scalars here (the learning rate, the count,
the bias corrections, the clip's norm or scale) and hands the update of
every leaf to ``ops/adam_cuda.adam_update``: on the card both orders are one
launch of one hand-written kernel, which differ only in rounding order; on
the CPU the plain PyTorch version of each order.

Both evaluate the schedule at the pre-increment count (step 0 uses
``schedule(0)``) and the bias corrections at the post-increment count.  The
count and every scalar derived from it are tensors on the parameters'
device, so a step never waits for the device.
"""
from __future__ import annotations

import math
from typing import Iterable

import torch

from ..ops.adam_cuda import adam_update

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
        clip_value = None
        if self.clip and self.clip > 0:
            norm = global_norm(grads)
            clip_value = (torch.clamp(self.clip / torch.clamp(norm, min=1e-12), max=1.0)
                          if self.impl == "fused" else norm)
        adam_update(self.params, grads, self.mu, self.nu, lr_t, bc1, bc2, clip_value,
                    impl=self.impl, b1=self.b1, b2=self.b2, eps=self.eps, clip=self.clip)

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

    ``impl="fused"`` is the same arithmetic in the JAX package's
    ``fused_adam`` order (module docstring).  ``state_dtype="bf16"`` stores
    the moments compressed (the update still runs in float32); it needs the
    fused implementation and is opt-in, never a default."""
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
        help="Adam's rounding order: optax (the plain chain, one operation "
             "at a time) or fused (the JAX package's fused_adam); on the card "
             "both are one kernel launch a step",
    )
    parser.add_argument(
        "--opt-state-dtype", dest="opt_state_dtype",
        choices=("f32", "bf16"), default="f32",
        help="Adam moment storage dtype (bf16 halves the moments' memory "
             "traffic; needs --opt-impl fused; resume with the same dtype)",
    )
