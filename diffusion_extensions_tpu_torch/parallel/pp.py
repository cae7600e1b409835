"""Pipeline parallelism: a GPipe microbatch pipeline over a stack of
identical layers (counterpart of ``diffusion_extensions_tpu/parallel/pp.py``).

Each of the P ranks of a process group holds L / P contiguous layers (its
stage).  The batch is cut into M microbatches; stage 0 feeds them in
order, every stage runs its layers on a microbatch and sends the result
one stage on, and the last stage's outputs are broadcast, so every rank
sees the sequential stack's output.  ``pipeline_apply`` is differentiable:
its backward runs the microbatches back through the stages (each stage
sends the gradient of its input one stage back) and gives each stage's
parameters the gradients of the stacked layers, and the input its
gradient on every rank.  The ranks run the same program around the
pipeline (the embedding, the head and the loss are replicated), so the
gradient of the output is the same on every rank; the last stage's is the
one that enters the pipeline.

The schedule is written by hand with point-to-point sends over the group
rather than taken from ``torch.distributed.pipelining``: the contract is
the JAX package's, a differentiable function that returns the output (and
the MoE aux loss) on every rank for any loss to use, while that library's
schedules own the loss and its backward and leave the output on the last
stage.  There are no warm-up or drain ticks to mask: a stage works only on
real microbatches.  The bubble is the textbook (P - 1) / (M + P - 1).
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist
from torch import nn

__all__ = ["pipeline_apply", "stack_layer_params", "shard_stacked_params"]


def stack_layer_params(per_layer: Sequence[nn.Module]) -> nn.ModuleList:
    """The L identical layers as one ``ModuleList`` (the layout
    ``shard_stacked_params`` cuts into stages)."""
    return nn.ModuleList(per_layer)


def _world(group) -> tuple[int, int]:
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def shard_stacked_params(layers: Sequence[nn.Module], group) -> nn.ModuleList:
    """This rank's stage of ``layers`` over the P ranks of ``group``: the
    contiguous L / P layers it holds (L must divide by P)."""
    p, s = _world(group)
    if len(layers) % p:
        raise ValueError(f"{len(layers)} layers do not divide over pp={p}")
    per = len(layers) // p
    return nn.ModuleList(list(layers)[s * per:(s + 1) * per])


class _Stage:
    """What the autograd function needs besides tensors."""

    def __init__(self, layer_fn, layers, group, n_microbatches, has_aux):
        self.layer_fn, self.layers, self.group = layer_fn, layers, group
        self.m, self.has_aux = n_microbatches, has_aux
        self.p, self.s = _world(group)

    def peer(self, stage: int) -> int:
        return dist.get_global_rank(self.group, stage)

    def run(self, h: torch.Tensor):
        """The stage's layers on one microbatch; aux summed over them."""
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for layer in self.layers:
            if self.has_aux:
                h, a = self.layer_fn(layer, h)
                aux = aux + a.float()
            else:
                h = self.layer_fn(layer, h)
        return h, aux


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage: _Stage, x: torch.Tensor, *params):
        mbs = x.chunk(stage.m)
        sends, h_ins, h_outs, auxs = [], [], [], []
        for m in range(stage.m):
            if stage.s == 0:
                h = mbs[m]
            else:
                h = torch.empty_like(mbs[m])
                dist.recv(h, stage.peer(stage.s - 1), group=stage.group)
            h_in = h.detach().requires_grad_(True)
            with torch.enable_grad():
                h_out, aux = stage.run(h_in)
            if h_out.shape != h_in.shape:
                raise ValueError(f"a stage maps {tuple(h_in.shape)} to {tuple(h_out.shape)}")
            h_out = h_out.to(x.dtype)
            if stage.s < stage.p - 1:
                sends.append(dist.isend(h_out.detach().contiguous(), stage.peer(stage.s + 1),
                                        group=stage.group))
            h_ins.append(h_in)
            h_outs.append(h_out)
            auxs.append(aux)
        for req in sends:
            req.wait()
        if stage.s == stage.p - 1:
            out = torch.cat([h.detach() for h in h_outs])
        else:
            out = torch.empty_like(x)
        aux = torch.stack([a.detach() for a in auxs]).sum()
        if stage.p > 1:
            dist.broadcast(out, stage.peer(stage.p - 1), group=stage.group)
            dist.all_reduce(aux, group=stage.group)
        ctx.stage, ctx.params = stage, params
        ctx.h_ins, ctx.h_outs, ctx.auxs = h_ins, h_outs, auxs
        return out, aux / stage.m

    @staticmethod
    def backward(ctx, grad_out, grad_aux):
        stage, params = ctx.stage, ctx.params
        grads = [torch.zeros_like(p) for p in params]
        g_mbs = grad_out.chunk(stage.m)
        sends, g_x = [], []
        for m in range(stage.m):
            if stage.s == stage.p - 1:
                g = g_mbs[m].contiguous()
            else:
                g = torch.empty_like(ctx.h_outs[m])
                dist.recv(g, stage.peer(stage.s + 1), group=stage.group)
            outs, gs = [ctx.h_outs[m]], [g]
            if stage.has_aux and ctx.auxs[m].requires_grad:
                outs.append(ctx.auxs[m])
                gs.append(grad_aux / stage.m)
            got = torch.autograd.grad(outs, [ctx.h_ins[m], *params], gs, allow_unused=True)
            g_in = got[0] if got[0] is not None else torch.zeros_like(ctx.h_ins[m])
            if stage.s > 0:
                sends.append(dist.isend(g_in.contiguous(), stage.peer(stage.s - 1),
                                        group=stage.group))
            else:
                g_x.append(g_in)
            for acc, gp in zip(grads, got[1:]):
                if gp is not None:
                    acc.add_(gp)
        for req in sends:
            req.wait()
        grad_x = torch.cat(g_x) if stage.s == 0 else torch.empty_like(grad_out)
        if stage.p > 1:
            dist.broadcast(grad_x, stage.peer(0), group=stage.group)
        ctx.h_ins = ctx.h_outs = ctx.auxs = None
        return (None, grad_x, *grads)


def pipeline_apply(layer_fn: Callable, layers: Sequence[nn.Module], x: torch.Tensor, group,
                   n_microbatches: int, layer_has_aux: bool = False):
    """Apply the L stacked layers to ``x`` through a P-stage pipeline over
    ``group`` (``None``: one stage).

    ``layers`` is this rank's stage (``shard_stacked_params``);
    ``layer_fn(layer, h) -> h`` applies one layer and keeps the shape.
    ``x`` is the whole batch, the same on every rank, with ``B %
    n_microbatches == 0``.  Returns the sequential stack's output on every
    rank.  ``layer_has_aux=True``: ``layer_fn`` returns ``(h, aux)`` (a MoE
    layer's load-balance loss) and the return is ``(out, aux)``, aux summed
    over the layers and averaged over the microbatches; each microbatch is
    routed on its own tokens."""
    if x.shape[0] % n_microbatches:
        raise ValueError(f"batch {x.shape[0]} does not divide into {n_microbatches} microbatches")
    stage = _Stage(layer_fn, layers, group, n_microbatches, layer_has_aux)
    params = [p for layer in layers for p in layer.parameters() if p.requires_grad]
    out, aux = _GPipe.apply(stage, x, *params)
    return (out, aux) if layer_has_aux else out
