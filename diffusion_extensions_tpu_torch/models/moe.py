"""Mixture-of-experts FFN with Switch-Transformer top-1 routing, and expert
parallelism (counterpart of ``diffusion_extensions_tpu/models/moe.py``).

A block's dense FFN becomes E experts whose parameters are stacked on a
leading E axis (``w1 (E, d, f)``, ``b1 (E, f)``, ``w2 (E, f, d)``,
``b2 (E, d)``, the layout of the JAX package's einsums).  Routing is top-1
with a fixed capacity ``C = ceil(T * capacity_factor / E)`` per expert;
tokens past an expert's capacity are dropped in token order (the layer's
residual carries them).  Every shape is static and nothing waits for the
device, so a train step that holds the layer can be captured in a CUDA
graph.

The Switch load-balance loss ``E * sum_e f_e p_e`` and the per-expert token
fractions ``f_e`` take the place of flax's ``sow``: each forward leaves
them on the module as ``aux_loss`` (a scalar in the autograd graph) and
``expert_frac`` (E,), for the caller to read right after the call
(``PlaneNet.moe_aux`` / ``PlaneNet.expert_fracs``).

``shard_moe_params(model, group)`` is expert parallelism: each rank of
``group`` keeps E / ep of every MoE layer's experts, runs them on its slice
of the (E, C, d) dispatch buffer, and the expert outputs come back through
an all-gather.  The ranks of the group hold the same tokens (a replicated
program, as the JAX package's GSPMD step over an ``"ep"`` axis is), so the
gather's backward takes each rank's own slice of the gradient, and the
slice's backward all-gathers the slices' gradients, so that every rank
holds the whole gradient of the tokens.

In the one-program step of ``parallel/gspmd.py`` the tokens are split
over ranks: the batch over ``dp_group`` and the points over ``sp_group``
(set by ``shard_params``).  The layer then routes the global batch as the
JAX package's GSPMD step does: the capacity follows the global token
count, a token's place in its expert's queue counts the tokens before it
in the global batch's (B, N) order on every rank, and the load-balance
loss takes the global fractions; each rank dispatches its own tokens.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch import nn

from .layers import _TRUNC_STD, _SumOverRanks, dense

__all__ = ["MoEFFN", "shard_moe_params", "EXPERT_LEAVES"]

EXPERT_LEAVES = ("w1", "b1", "w2", "b2")


def _lecun_normal_stacked(shape) -> torch.Tensor:
    """flax ``lecun_normal(batch_axis=(0,))`` of an (E, fan_in, fan_out)
    kernel: a truncated normal of std sqrt(1 / fan_in), cut at 2 std."""
    std = math.sqrt(1.0 / shape[-2]) / _TRUNC_STD
    w = torch.empty(shape)
    nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std)
    return w


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(ranks, *x.shape): ``x`` of every rank of ``group``, in rank order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts)


class _TakeExperts(torch.autograd.Function):
    """This rank's slice along E of the (replicated) dispatch buffer; its
    backward all-gathers the slices' gradients, so every rank gets the
    whole gradient of the buffer."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.chunk(dist.get_world_size(group), dim=0)[dist.get_rank(group)].clone()

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad, ctx.group).flatten(0, 1), None


class _GatherExperts(torch.autograd.Function):
    """All-gather of the experts' outputs along E over the expert-parallel
    group; its backward keeps this rank's slice of the (replicated)
    upstream gradient."""

    @staticmethod
    def forward(ctx, h, group):
        ctx.group = group
        return _all_gather(h, group).flatten(0, 1)

    @staticmethod
    def backward(ctx, grad):
        ep, rank = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return grad.chunk(ep, dim=0)[rank], None


class MoEFFN(nn.Module):
    """Top-1 routed mixture of two-layer ReLU FFN experts: (B, N, dim) ->
    (B, N, dim).

    ``dispatch="onehot"`` dispatches and combines with (T, E, C) one-hot
    einsums (memory T * E * C); ``"scatter"`` gives each kept token the
    unique slot ``expert * C + pos`` of the (E * C, d) buffer and sends
    dropped tokens to one extra row that is never read (memory T * d).
    Both route alike and share one parameter set.  The router runs in
    float32 with autocast off; under bf16 autocast the expert products run
    in bf16."""

    def __init__(self, dim: int, n_experts: int, dim_feedforward: int = 2048,
                 capacity_factor: float = 1.25, dispatch: str = "onehot"):
        super().__init__()
        if dispatch not in ("onehot", "scatter"):
            raise ValueError(f"unknown dispatch {dispatch!r} (expected 'onehot' or 'scatter')")
        self.n_experts, self.capacity_factor, self.dispatch = n_experts, capacity_factor, dispatch
        self.router = dense(dim, n_experts)
        self.w1 = nn.Parameter(_lecun_normal_stacked((n_experts, dim, dim_feedforward)))
        self.b1 = nn.Parameter(torch.zeros(n_experts, dim_feedforward))
        self.w2 = nn.Parameter(_lecun_normal_stacked((n_experts, dim_feedforward, dim)))
        self.b2 = nn.Parameter(torch.zeros(n_experts, dim))
        self.ep_group = None  # set by shard_moe_params
        self.dp_group = self.sp_group = None  # set by parallel/gspmd.py shard_params
        self.aux_loss: torch.Tensor | None = None
        self.expert_frac: torch.Tensor | None = None

    def capacity(self, tokens: int) -> int:
        """ceil(tokens * capacity_factor / E), as the JAX package computes it."""
        return int(-(-tokens * self.capacity_factor // self.n_experts))

    def _token_groups(self) -> list:
        return [g for g in (self.sp_group, self.dp_group) if g is not None]

    def _global_tokens(self, tokens: int) -> int:
        """The token count of the global batch this rank holds ``tokens`` of."""
        return tokens * math.prod(dist.get_world_size(g) for g in self._token_groups())

    def width(self, tokens: int) -> int:
        """The dispatch buffer's slots per expert: the capacity, or this
        rank's token count where that is less."""
        return min(self.capacity(self._global_tokens(tokens)), tokens)

    def _earlier_elsewhere(self, onehot: torch.Tensor, rows: int) -> torch.Tensor:
        """Per token, the tokens of its expert that come before it in the
        global batch's (B, N) order and that the local running count does
        not see: those of other ranks, less the local earlier rows'."""
        e = self.n_experts
        mine = onehot.reshape(rows, -1, e).sum(dim=1)  # (rows, E)
        row_total, before = mine, torch.zeros_like(mine)
        if self.sp_group is not None:  # the row's points on the sp ranks before this one
            parts = _all_gather(mine, self.sp_group)
            before = parts[: dist.get_rank(self.sp_group)].sum(dim=0)
            row_total = parts.sum(dim=0)
        first = 0
        if self.dp_group is not None:  # the rows of the dp ranks before this one
            first = dist.get_rank(self.dp_group) * rows
            row_total = _all_gather(row_total, self.dp_group).flatten(0, 1)
        rows_before = torch.cumsum(row_total, dim=0) - row_total
        offset = before + rows_before[first:first + rows] - (torch.cumsum(mine, dim=0) - mine)
        per_token = offset[:, None, :].expand(rows, onehot.shape[0] // rows, e).reshape(-1, e)
        return torch.sum(per_token * onehot, dim=-1)

    def route(self, tokens: torch.Tensor, rows: int = 1):
        """(probs (T, E), gate (T,), expert (T,), keep (T,) bool, pos (T,)):
        the float32 softmax router's top-1 choice, and each token's place
        in its expert's queue (kept when under the capacity).  ``tokens``
        holds ``rows`` rows of the batch, row-major; with token groups
        ``keep`` follows the global queue and ``pos`` is the local one."""
        e, t = self.n_experts, tokens.shape[0]
        cap = self.capacity(self._global_tokens(t))
        with torch.autocast(tokens.device.type, enabled=False):
            logits = self.router(tokens.float())
        probs = torch.softmax(logits, dim=-1)
        gate = probs.amax(dim=-1)
        expert = torch.argmax(probs, dim=-1)
        onehot = (expert[:, None] == torch.arange(e, device=tokens.device)).float()
        # the running count down the tokens, scanned along the contiguous
        # axis of the (E, T) transpose (a scan down T rows of E = 4 columns
        # runs ~0.7 ms a layer on an H100)
        count = torch.cumsum(onehot.t().contiguous(), dim=1).t()
        pos = torch.sum(count * onehot, dim=-1) - 1.0
        groups = self._token_groups()
        if groups:
            n = self._global_tokens(t)
            frac, mean_probs = onehot.sum(dim=0), probs.sum(dim=0)
            for g in groups:  # differentiable: the aux's gradient reaches every rank
                frac = _SumOverRanks.apply(frac, g)
                mean_probs = _SumOverRanks.apply(mean_probs, g)
            self.expert_frac, mean_probs = frac / n, mean_probs / n
            keep = pos + self._earlier_elsewhere(onehot, rows) < cap
        else:
            self.expert_frac, mean_probs = onehot.mean(dim=0), probs.mean(dim=0)
            keep = pos < cap
        self.aux_loss = e * torch.sum(self.expert_frac * mean_probs)
        pos = torch.clamp(pos, 0, min(cap, t) - 1).long()
        return probs, gate, expert, keep, pos

    def _experts(self, xin: torch.Tensor) -> torch.Tensor:
        """The experts' FFN over the (E, C, d) buffer; with expert
        parallelism this rank's E / ep experts on their slice, gathered."""
        if self.ep_group is not None:
            xin = _TakeExperts.apply(xin, self.ep_group)
        h = torch.relu(torch.baddbmm(self.b1[:, None, :], xin, self.w1))
        h = torch.baddbmm(self.b2[:, None, :], h, self.w2)
        if self.ep_group is not None:
            h = _GatherExperts.apply(h, self.ep_group)
        return h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        t, e = b * n, self.n_experts
        cap = self.width(t)
        tokens = x.reshape(t, d)
        _, gate, expert, keep, pos = self.route(tokens, rows=b)
        if self.dispatch == "onehot":
            slots = (pos[:, None] == torch.arange(cap, device=x.device)).float()
            onehot = (expert[:, None] == torch.arange(e, device=x.device)).float()
            dispatch = onehot[:, :, None] * slots[:, None, :] * keep[:, None, None]
            xin = torch.einsum("tec,td->ecd", dispatch, tokens)
            h = self._experts(xin)
            combine = dispatch * gate[:, None, None]
            out = torch.einsum("tec,ecd->td", combine, h).float()
        else:
            slot = torch.where(keep, expert * cap + pos, e * cap)
            buf = torch.zeros(e * cap + 1, d, dtype=tokens.dtype, device=x.device)
            xin = buf.index_copy(0, slot, tokens)[: e * cap].reshape(e, cap, d)
            h = self._experts(xin).reshape(e * cap, d)
            # index_select's backward adds each row's gradient in place; the
            # dropped tokens' rows carry zeros, so the sums are exact
            out = torch.index_select(h, 0, torch.clamp(slot, max=e * cap - 1)).float()
            out = out * (gate * keep)[:, None]
        return out.reshape(b, n, d)


def shard_moe_params(model: nn.Module, group) -> list[str]:
    """Expert parallelism over ``group`` (ep ranks): every ``MoEFFN`` of
    ``model`` keeps the slice of its expert leaves (``w1``, ``b1``, ``w2``,
    ``b2``; never the router) that this rank owns on their leading E axis.
    E must divide by ep.  Returns the names of the sharded leaves."""
    ep, rank = dist.get_world_size(group), dist.get_rank(group)
    sharded = []
    for name, mod in model.named_modules():
        if not isinstance(mod, MoEFFN):
            continue
        if mod.n_experts % ep:
            raise ValueError(f"{name}: {mod.n_experts} experts do not divide over ep={ep}")
        for leaf in EXPERT_LEAVES:
            full = getattr(mod, leaf)
            local = full.detach().chunk(ep, dim=0)[rank].clone()
            setattr(mod, leaf, nn.Parameter(local, requires_grad=full.requires_grad))
            sharded.append(f"{name}.{leaf}" if name else leaf)
        mod.ep_group = group
    return sharded
