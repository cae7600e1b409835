"""The dp x sp x tp (+ fsdp) train step: one program over the global batch
(counterpart of ``diffusion_extensions_tpu/parallel/gspmd.py``).

The JAX package writes the step over the logical global batch, annotates
shardings and lets XLA insert the collectives.  Here each rank of a
``DeviceMesh`` with axes ``("dp", "sp", "tp")`` runs the same program on
its slice, with PyTorch's own parallel layers:

* **tp**: Megatron column / row pairs in every encoder layer
  (``ColwiseParallel`` on q / k / v and the first feed-forward layer,
  ``RowwiseParallel`` on the attention output and the second), so each tp
  rank runs heads / tp heads and 1 / tp of the feed-forward width, and
  one all-reduce a pair joins them.  A pair is sharded only when
  ``tp_kernel_spec`` shards its column layer's output (at least
  ``min_dim`` and divisible by tp; the heads too); otherwise it stays
  replicated.
* **sp**: the points axis of the clouds is split over "sp"; the attention
  gathers keys and values over the sp ranks and ``PoolRN``'s sums over
  the points are all-reduced.
* **fsdp**: ``fully_shard`` each encoder layer, then the root, over "dp":
  the weights and the port's Adam moments live sharded (on the dimension
  ``param_spec`` picks), each layer's weights are gathered for its
  forward and backward and its gradients reduce-scattered.

Without fsdp the gradients are averaged over "dp"; with sp also over
"sp" (each sp rank's local gradient counts every token once through the
differentiable collectives, so the mean over the sp ranks is the global
gradient).  The noise is drawn once for the global batch, from the same
generator on every rank, and the MoE layers route the global batch, so
the numerics do not depend on the mesh (the loss function draws the noise
and takes its slice: ``experiments/aircraft.py`` ``make_global_loss_fn``).
The step runs eagerly, one step a call.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from ..train.optim import Adam
from ..train.state import TrainState
from .dp import mean_over, slice_dim
from .mesh import P, axis_size

__all__ = ["make_gspmd_train_step", "tp_kernel_spec", "param_spec", "batch_spec",
           "shard_params", "shard_global_batch"]


def tp_kernel_spec(x, tp_size: int, tp_axis: str = "tp", min_dim: int = 64) -> P:
    """The JAX rule for one leaf in flax layout (..., in, out): a matrix
    whose output (last) dimension is at least ``min_dim`` and divides by
    ``tp_size`` is sharded on it; everything else is replicated."""
    shape = tuple(x.shape)
    if tp_size > 1 and len(shape) >= 2 and shape[-1] >= min_dim and shape[-1] % tp_size == 0:
        return P(*([None] * (len(shape) - 1)), tp_axis)
    return P()


def param_spec(x, tp_size: int, dp_size: int = 1, tp_axis: str = "tp", dp_axis: str = "dp",
               min_dim: int = 64, fsdp: bool = False) -> P:
    """tp (``tp_kernel_spec``) plus, with ``fsdp``, the largest remaining
    dimension that divides by ``dp_size`` and is at least ``min_dim``
    sharded over ``dp_axis`` (the JAX rule; a pure function of the
    shape)."""
    base = tp_kernel_spec(x, tp_size, tp_axis, min_dim)
    shape = tuple(x.shape)
    if not fsdp or dp_size <= 1 or len(shape) < 1:
        return base
    assign = list(base) + [None] * (len(shape) - len(base))
    candidates = [(shape[d], d) for d in range(len(shape))
                  if assign[d] is None and shape[d] % dp_size == 0 and shape[d] >= min_dim]
    if not candidates:
        return base
    assign[max(candidates)[1]] = dp_axis
    return P(*assign)


def batch_spec(x, dp_axis: str = "dp", sp_size: int = 1, sp_axis: str = "sp") -> P:
    """A batch leaf's layout: the batch dimension over dp, and with sp the
    sequence dimension (points) over sp when it divides."""
    ndim = len(x.shape)
    if ndim == 0:
        return P()
    if sp_size > 1 and ndim >= 2 and x.shape[1] % sp_size == 0 and x.shape[1] >= sp_size:
        return P(dp_axis, sp_axis, *([None] * (ndim - 2)))
    return P(dp_axis, *([None] * (ndim - 1)))


def shard_global_batch(mesh, tensors, seq_dims=(), dp_axis: str = "dp", sp_axis: str = "sp"):
    """This rank's slices of global batch tensors: the leading dimension
    of each over ``dp_axis``, and the tensors whose index is in
    ``seq_dims`` also on dimension 1 over ``sp_axis`` (``batch_spec``)."""
    out = []
    for i, x in enumerate(tensors):
        if axis_size(mesh, dp_axis) > 1:
            x = slice_dim(x, 0, mesh.get_group(dp_axis))
        if i in seq_dims and axis_size(mesh, sp_axis) > 1:
            if batch_spec(x, dp_axis, axis_size(mesh, sp_axis), sp_axis)[1:2] != (sp_axis,):
                raise ValueError(f"sequence dimension {x.shape[1]} does not divide over sp")
            x = slice_dim(x, 1, mesh.get_group(sp_axis))
        out.append(x)
    return out


# Megatron pairs of an encoder layer: (column-parallel layers, row-parallel layer)
_TP_PAIRS = ((("query", "key", "value"), "out"), (("ff1",), "ff2"))


def _tensor_parallel(model: nn.Module, mesh, tp_axis: str, min_dim: int) -> list[str]:
    from torch.distributed.tensor.parallel import (
        ColwiseParallel,
        RowwiseParallel,
        parallelize_module,
    )

    from ..models.layers import TransformerEncoderLayer

    tp = axis_size(mesh, tp_axis)
    done = []
    for name, layer in model.named_modules():
        if not isinstance(layer, TransformerEncoderLayer):
            continue
        plan = {}
        for cols, row in _TP_PAIRS:
            if not all(hasattr(layer, c) and isinstance(getattr(layer, c), nn.Linear)
                       for c in cols + (row,)):
                continue  # fused qkv or a MoE feed-forward: replicated
            kernel = getattr(layer, cols[0]).weight.T  # flax layout (in, out)
            if tp_kernel_spec(kernel, tp, tp_axis, min_dim) == P():
                continue
            if "query" in cols and layer.heads % tp:
                continue
            plan.update({c: ColwiseParallel() for c in cols})
            plan[row] = RowwiseParallel()
        if plan:
            parallelize_module(layer, mesh[tp_axis], plan)
            done += [f"{name}.{k}" for k in plan]
    return done


def shard_params(model: nn.Module, mesh, tp_axis: str = "tp", min_dim: int = 64,
                 dp_axis: str = "dp", sp_axis: str = "sp", fsdp: bool = False) -> nn.Module:
    """Lay ``model`` out on ``mesh`` in place (before its optimizer is
    made): tp pairs, the sequence-parallel group on the attention, the
    pooling and the MoE layers, the dp group on the MoE layers, and with
    ``fsdp`` FSDP2 over ``dp_axis``.  Returns ``model``."""
    if axis_size(mesh, tp_axis) > 1:
        _tensor_parallel(model, mesh, tp_axis, min_dim)
    # the sp group on the attention, the pooling and the MoE layers; the dp
    # group on the MoE layers, which route the global batch
    for axis, attr in ((sp_axis, "sp_group"), (dp_axis, "dp_group")):
        if axis_size(mesh, axis) > 1:
            group = mesh.get_group(axis)
            for mod in model.modules():
                if hasattr(mod, attr):
                    setattr(mod, attr, group)
    if fsdp:
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import DTensor, Shard

        from ..models.layers import TransformerEncoderLayer

        dp = axis_size(mesh, dp_axis)

        def placement(param):
            if isinstance(param, DTensor):
                return None  # tp-sharded: FSDP2's own choice
            spec = param_spec(param, 1, dp, tp_axis, dp_axis, min_dim, fsdp=True)
            return Shard(spec.index(dp_axis)) if dp_axis in spec else None

        dp_mesh = mesh[dp_axis]
        for layer in [m for m in model.modules() if isinstance(m, TransformerEncoderLayer)]:
            fully_shard(layer, mesh=dp_mesh, shard_placement_fn=placement)
        fully_shard(model, mesh=dp_mesh, shard_placement_fn=placement)
    return model


def make_gspmd_train_step(loss_fn: Callable, model: nn.Module, optimizer: Adam, mesh,
                          dp_axis: str = "dp", sp_axis: str = "sp", fsdp: bool = False):
    """Build ``step(state, batch) -> (state, metrics)`` over ``mesh``.

    ``model`` is laid out by ``shard_params`` (same ``fsdp``) and
    ``optimizer`` made over its parameters after that.  ``loss_fn(generator,
    batch)`` takes the GLOBAL batch, draws the noise for all of it from
    ``generator`` (the same state on every rank) and returns the mean loss
    of this rank's slice.  The gradients are averaged over dp (by FSDP2's
    reduce-scatter with ``fsdp``) and sp; ``metrics["loss"]`` is the global
    batch's loss."""
    params = [p for p in model.parameters() if p.requires_grad]
    dp, sp = axis_size(mesh, dp_axis), axis_size(mesh, sp_axis)
    grad_groups = [mesh.get_group(dp_axis)] if dp > 1 and not fsdp else []
    if sp > 1:
        grad_groups.append(mesh.get_group(sp_axis))
    loss_groups = [mesh.get_group(dp_axis)] if dp > 1 else []

    def step(state: TrainState, batch):
        optimizer.zero_grad()
        loss = loss_fn(state.generator, batch)
        loss.backward()
        with torch.no_grad():
            mean_over([p.grad for p in params], grad_groups)
            optimizer.step()
            loss = loss.detach().reshape(1).clone()
            mean_over([loss], loss_groups)
        state.step += 1
        return state, {"loss": loss[0]}

    return step
