"""The data-parallel train step (counterpart of
``diffusion_extensions_tpu/parallel/dp.py``).

One process per card: each rank of a ``"dp"`` process group computes the
loss and its gradients on its slice of the global batch (``shard_batch``),
and the gradients are averaged over the group (one all-reduce of all of
them, the JAX package's ``pmean``) before the optimizer update, so every
rank applies the same update and the weights stay replicated.  The loss
reported is the group's mean.  Without a group (or in a group of one) the
step is the single-device step.

Where the JAX package fuses K steps of one call with ``lax.scan`` to save
dispatches, this module captures one step (loss, backward, all-reduce,
optimizer update) in a CUDA graph and replays it for each sub-step, so a
step costs the host one copy into the graph's input and one launch.

Spans (``obs``): ``train.step`` around a step's device work, with
``train.backward`` (the backward and the group's reduce) and
``train.optimizer`` inside it (the loss function opens its own), and the
host spans ``train.capture`` and ``train.replay``.  Counters:
``train.captures``, ``train.replays``, ``train.eager_steps``,
``train.graph_kernels`` (the kernel, copy and fill nodes of each captured
step, stamps left out) and ``train.capture_ns``.
"""
from __future__ import annotations

import time
from typing import Callable

import torch
import torch.distributed as dist
from torch import nn

from .. import obs
from ..train.optim import Adam, global_norm
from ..train.state import TrainState

__all__ = ["make_dp_train_step", "shard_batch", "mean_over"]


def slice_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's part of dimension ``dim`` of ``x``, cut into the group's
    world size of equal parts."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of size {x.shape[dim]} does not divide over {n} ranks")
    size = x.shape[dim] // n
    return x.narrow(dim, r * size, size)


def shard_batch(batch, group=None):
    """This rank's slice of a global batch: the leading dimension of every
    tensor cut into the group's world size of equal parts (the whole batch
    without a group)."""
    return batch if group is None else _map(lambda x: slice_dim(x, 0, group), batch)


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a plain tensor as it is)."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def mean_over(tensors: list, groups: list) -> None:
    """Average ``tensors`` in place over each process group of ``groups``
    in turn: one all-reduce of one flat buffer a group.  A DTensor is
    averaged through its local shard."""
    if not groups:
        return
    local = [_local(t) for t in tensors]
    flat = torch.cat([t.reshape(-1) for t in local])
    for group in groups:
        dist.all_reduce(flat, group=group)
        flat /= dist.get_world_size(group)
    offset = 0
    for t in local:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def _index(batch, i: int):
    """Sub-step ``i`` of a batch with a leading K axis (a tensor, or a
    tuple / NamedTuple / list / dict of them, nested)."""
    return _map(lambda x: x[i], batch)


def _leaves(batch) -> list[torch.Tensor]:
    if isinstance(batch, torch.Tensor):
        return [batch]
    values = batch.values() if isinstance(batch, dict) else batch
    return [leaf for v in values for leaf in _leaves(v)]


def _map(fn, batch):
    """``fn`` on every tensor of ``batch``, its structure kept; a NamedTuple
    is rebuilt field by field (its constructor takes no iterable)."""
    if isinstance(batch, torch.Tensor):
        return fn(batch)
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    if hasattr(batch, "_fields"):
        return type(batch)(*(_map(fn, v) for v in batch))
    return type(batch)(_map(fn, v) for v in batch)


class _CapturedStep:
    """One train step (the gradients' memory zeroed, then ``body(generator,
    batch) -> (loss, gradients)``, the eager step's own) captured in a CUDA
    graph over a static copy of ``batch``, with the state's generator
    registered so that every replay draws anew.  The capture runs nothing:
    the state is as it was.  ``stream`` is the side stream of the eager step
    before the first capture: the backward pass accumulates gradients on
    the stream that first did.  A step that cannot be captured raises from
    here."""

    def __init__(self, optimizer, body, generator, batch, stream):
        t0 = time.perf_counter_ns()
        with obs.span("train.capture", device=False):
            self.generator = generator
            self.batch = _map(torch.clone, batch)
            self.graph = torch.cuda.CUDAGraph()
            self.graph.register_generator_state(generator)
            optimizer.zero_grad()
            with torch.cuda.graph(self.graph, stream=stream), obs.capture_count("train"):
                loss, self.grads = body(generator, self.batch)
            self.loss = loss.detach()  # keeps the value's memory, not the autograd graph
        obs.count("train.capture_ns", time.perf_counter_ns() - t0)

    def fits(self, batch) -> bool:
        mine, theirs = _leaves(self.batch), _leaves(batch)
        return len(mine) == len(theirs) and all(
            a.shape == b.shape and a.dtype == b.dtype for a, b in zip(mine, theirs))

    def __call__(self, batch) -> torch.Tensor:
        with obs.span("train.replay", device=False):
            for dst, src in zip(_leaves(self.batch), _leaves(batch)):
                dst.copy_(src, non_blocking=True)
            self.graph.replay()
        obs.count("train.replays")
        return self.loss


def make_dp_train_step(
    loss_fn: Callable,
    model: nn.Module,
    optimizer: Adam,
    steps_per_call: int = 1,
    log_norms: bool = False,
    per_layer_norms: bool = False,
    skip_nonfinite: bool = False,
    group=None,
):
    """Build ``step(state, batch) -> (state, metrics)``.

    ``loss_fn(generator, batch) -> scalar loss`` evaluates ``model`` (which
    it closes over) on the batch, mean-reduced, drawing its randomness from
    ``generator``.  A step computes the loss and its gradients, applies
    ``optimizer`` and adds one to ``state.step``; ``state`` is updated in
    place.  ``metrics`` holds scalar tensors (``"loss"``, ...), left on the
    device so that a step never waits for it.

    ``steps_per_call > 1``: the batch carries a leading axis of K <=
    ``steps_per_call`` sub-batches; K sequential steps run and the last
    sub-step's metrics are reported.  On a CUDA device the first sub-step
    of the first call runs eagerly (on a side stream, which is what a
    capture of a backward pass needs before it), then one step is captured
    in a CUDA graph and every later sub-step replays it; a capture that
    fails raises.  With ``skip_nonfinite``, or under
    ``torch.autograd.set_detect_anomaly``, both of which look at values on
    the host, the K steps run eagerly.

    ``log_norms`` adds ``grad_norm`` and ``param_norm`` (after the update),
    ``per_layer_norms`` one ``grad_norm/<top-level module>`` per top-level
    child of ``model``; they are computed on the last sub-step only.

    ``skip_nonfinite``: a step whose loss or gradient norm is not finite
    leaves weights and optimizer state untouched while the step counter
    (and the generator) advance; the check waits for the device.

    ``group``: the ``"dp"`` process group.  Every rank passes the same
    global batch and ``loss_fn`` takes its slice (``shard_batch``) after it
    draws the randomness for the whole batch from the state's generator,
    which every rank holds alike (``experiments/aircraft.py``
    ``make_global_loss_fn``); the gradients and the reported loss are the
    group's means.  One all-reduce runs here, before any capture, so that
    the communicator exists outside it; a captured step holds its
    all-reduce.
    """
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    if group is not None:
        dist.all_reduce(torch.zeros(1, device=params[0].device), group=group)

    def reduce(loss: torch.Tensor, grads: list) -> torch.Tensor:
        """The group's mean of the gradients (in place) and of the loss."""
        if group is None:
            return loss
        loss = loss.detach().reshape(1).clone()
        mean_over(grads + [loss], [group])
        return loss[0]

    def add_norms(metrics: dict, grads: list) -> None:
        """The norms of the step's gradients and of the weights after it."""
        if not log_norms:
            return
        metrics["grad_norm"] = global_norm(grads)
        metrics["param_norm"] = global_norm([p.detach() for p in params])
        if per_layer_norms:
            groups: dict[str, list] = {}
            for name, g in zip(names, grads):
                groups.setdefault(name.split(".")[0], []).append(g)
            for k, gs in groups.items():
                metrics[f"grad_norm/{k}"] = global_norm(gs)

    def body(generator, batch):
        """One step's work, eager or under capture, after the gradients'
        memory is zeroed: the loss, its backward, the group's reduce, the
        update (skipped with ``skip_nonfinite`` where the loss or the
        gradients' norm is not finite, a check that waits for the device).
        Returns (loss, gradients)."""
        with obs.span("train.step"):
            loss = loss_fn(generator, batch)
            with obs.span("train.backward"):
                loss.backward()
                grads = [p.grad for p in params]
                loss = reduce(loss, grads)
            if not skip_nonfinite or bool(torch.isfinite(loss) & torch.isfinite(global_norm(grads))):
                with obs.span("train.optimizer"):
                    optimizer.step()
        return loss, grads

    def one_step(state: TrainState, batch, want_norms: bool = True):
        optimizer.zero_grad()
        loss, grads = body(state.generator, batch)
        obs.count("train.eager_steps")
        state.step += 1
        metrics = {"loss": loss.detach()}
        if want_norms:
            add_norms(metrics, grads)
        return state, metrics

    if steps_per_call == 1:
        return one_step

    captured: list[_CapturedStep] = []  # one graph per sub-batch shape
    side: list[torch.cuda.Stream] = []  # made at the first call on the card

    def replay_step(state: TrainState, batch, want_norms: bool):
        graph = next((g for g in captured if g.fits(batch)), None)
        if graph is None:
            out = None
            if not captured:  # the eager step that a first capture needs before it
                side.append(torch.cuda.Stream())
                side[0].wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side[0]):
                    out = one_step(state, batch, want_norms)
                torch.cuda.current_stream().wait_stream(side[0])
            graph = _CapturedStep(optimizer, body, state.generator, batch, side[0])
            captured.append(graph)
            if out is not None:
                return out
        if graph.generator is not state.generator:
            raise ValueError("the step was captured with another generator than this state's")
        loss = graph(batch)
        state.step += 1
        metrics = {"loss": loss.detach().clone()}
        if want_norms:
            add_norms(metrics, graph.grads)
        return state, metrics

    def k_steps(state: TrainState, batches):
        k = _leaves(batches)[0].shape[0]
        if not 1 <= k <= steps_per_call:
            raise ValueError(f"batch carries {k} sub-batches, steps_per_call is {steps_per_call}")
        on_card = params[0].device.type == "cuda"
        eager = not on_card or skip_nonfinite or torch.is_anomaly_enabled()
        for i in range(k):
            step = one_step if eager else replay_step
            state, metrics = step(state, _index(batches, i), i == k - 1)
        return state, metrics

    return k_steps
