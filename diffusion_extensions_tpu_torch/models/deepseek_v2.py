"""DeepSeek-V2's decoder block as a trunk over a point set (no counterpart in
the JAX package): RMSNorm pre-norm blocks of multi-head latent attention
(MLA) and a SwiGLU feed-forward, dense in the first
``first_k_dense_replace`` layers and a DeepSeekMoE layer after them (Dai et
al. 2024, arXiv:2401.06066; DeepSeek-AI 2024, arXiv:2405.04434), with the
keys and sizes of the published ``config.json``.

A layer, x (B, N, d), no biases anywhere:

    h = x + MLA(RMSNorm(x));  out = h + FFN(RMSNorm(h))

MLA: q = W_q x, H heads of (nope + rope) dims; [c, k_pe] = W_kva x, c =
RMSNorm(c) (``kv_lora_rank`` wide); [k_nope, v] = W_kvb c, H heads of (nope
+ v) dims; k = [k_nope, k_pe broadcast over the heads]; softmax(q k^T s) v
over all N points, s = (nope + rope)^-1/2 m^2 with YaRN's m = 0.1
mscale_all_dim ln(factor) + 1, as HF's DeepSeek-V2 attention scales it;
W_o maps H v dims back to d.  The dense FFN is W_down(silu(W_gate x) *
W_up x).  The MoE FFN scores all E routed experts, s = softmax(W_g x) in
float32 with autocast off, takes the top k by score (greedy) with weights
s_i, not renormalised, times ``routed_scaling_factor``, and returns
Shared(x) + sum over the top k of the held experts of s_i E_i(x); each
expert is a SwiGLU of ``moe_intermediate_size``, the shared experts one
SwiGLU of ``n_shared_experts`` times that width.  Dropless: every token
reaches every one of its chosen experts that this layer holds.

The layer holds ``experts_held`` experts, ids ``first_expert`` onward: an
expert-parallel rank's share (stacked on a leading axis, as
``models/moe.py`` stacks them).  It routes over all E and computes its own
experts' part of the result; the part of absent experts is left out.  The
load-balance loss is DeepSeek's sequence-wise one over all E experts, per
cloud b of N points: f_bi = E / (k N) #{t in b: i in topk(t)}, P_bi =
mean over t of s_ti, loss = mean_b sum_i f_bi P_bi (``aux_loss``; the
caller weights it by ``aux_loss_alpha``).

Departures from the language model, for a set of points: no rotary
rotation (q_pe and k_pe are used as they are, the rotation at position 0,
so YaRN's extension of the context is left out and its softmax scale
kept), no causal mask, and no token embedding, LM head or multi-token
prediction (PlaneNet's embedding, pool and head stand in their place).

Dispatch keeps every shape static and never waits for the device, so a
train step holding the layer can be captured in a CUDA graph: the T k
choices are sorted by held expert (the others last), the held experts'
rows go through ``torch._grouped_mm`` with the groups' ends on the
device, and each token's rows come back through the inverse permutation.
The rows past the held ones are the others' choices, which the grouped
products neither read nor write; nothing downstream reads them either.
The row passes around the grouped products (the dispatch's gather, the
SwiGLU activation, the weighted combine, and their backwards) are
``ops/moe_rows_cuda.py``'s: on the card hand-written kernels that read the
held rows' count there and touch only those rows, on the CPU the plain
PyTorch chain.  A token's rows are summed in the fixed order of its k
choices (no atomic adds), so replayed steps repeat eager steps' bits.  On
the card the grouped products take bf16 (the trunk runs under autocast).

With ``scoring_func`` "sigmoid" (DeepSeek-V3's auxiliary-loss-free
routing, arXiv:2412.19437 sec. 2.1.2, as Kimi Linear routes) the scores are
s = sigmoid(W_g x), the top k are those of s + b, b the layer's correction
bias (``e_score_correction_bias``, a float32 buffer from 0), the weights
s_i, divided by the top k's sum where ``norm_topk_prob``, times
``routed_scaling_factor``; ``after_step()``, which the train step calls
once after each optimizer step, moves b_i by ``bias_update_speed`` sign(c
- c_i), c_i expert i's choices in the last forward (summed over the
data-parallel ranks) and c their mean, on the device.  With ``aux_loss_alpha`` 0 no balance loss is computed.

Spans (``obs``): ``ffn.dense`` around a dense FFN and ``moe.l<i>`` around
the MoE FFN of layer i (router, dispatch, experts, combine, shared
experts), each stamped at its end.  Device counters: ``moe.rows`` (the
held experts' rows), ``moe.rows_max`` (the busiest held expert's rows),
``moe.layer_steps``, ``moe.experts_held`` and ``moe.rows_even`` (the held
experts' even share of the choices, T k held / E rounded down), summed
over layers and steps.  At a capture, ``moe.graph_kernels`` counts the graph nodes the MoE
layers' forwards add and ``moe.captures`` the forwards captured.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch
import torch.distributed as dist
from torch import nn
from torch.nn import functional as F

from .. import obs
from ..ops import mla_attention_cuda as mla_attention
from ..ops import moe_rows_cuda as moe_rows
from .layers import _TRUNC_STD, widen
from .moe import _lecun_normal_stacked

__all__ = ["DeepSeekV2Config", "DEEPSEEK_V2_LITE", "TRUNKS", "RMSNorm", "SwiGLU", "MLA", "DeepSeekMoE",
           "DeepSeekV2Layer", "DeepSeekV2Trunk"]


@dataclass(frozen=True)
class DeepSeekV2Config:
    """The trunk's sizes, under the keys of the published ``config.json``;
    ``rope_factor`` and ``mscale_all_dim`` are its ``rope_scaling``'s
    ``factor`` and ``mscale_all_dim``, ``aux_loss_alpha`` the weight of the
    balance loss, ``experts_held`` / ``first_expert`` the routed experts
    this layer holds; ``scoring_func``, ``norm_topk_prob`` and
    ``bias_update_speed`` select DeepSeek-V3's sigmoid routing with a
    correction bias (the module docstring)."""

    hidden_size: int = 2048
    num_attention_heads: int = 16
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    kv_lora_rank: int = 512
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    first_k_dense_replace: int = 1
    num_hidden_layers: int = 27
    rms_norm_eps: float = 1e-6
    routed_scaling_factor: float = 1.0
    aux_loss_alpha: float = 0.001
    rope_factor: float = 40.0
    mscale_all_dim: float = 0.707
    experts_held: int = 64
    first_expert: int = 0
    scoring_func: str = "softmax"
    norm_topk_prob: bool = False
    bias_update_speed: float = 0.0

    @property
    def softmax_scale(self) -> float:
        m = 0.1 * self.mscale_all_dim * math.log(self.rope_factor) + 1.0 if self.rope_factor > 1 else 1.0
        return (self.qk_nope_head_dim + self.qk_rope_head_dim) ** -0.5 * m * m


# DeepSeek-V2-Lite (huggingface.co/deepseek-ai/DeepSeek-V2-Lite, config.json)
DEEPSEEK_V2_LITE = DeepSeekV2Config()
# the trunks the aircraft driver's --trunk names: one expert-parallel rank of
# eight (8 of the 64 experts of every MoE layer), 1 dense + 4 MoE layers
TRUNKS = {"dsv2lite-ep8": replace(DEEPSEEK_V2_LITE, num_hidden_layers=5, experts_held=8)}


def _linear(fan_in: int, fan_out: int) -> nn.Linear:
    """A bias-free ``nn.Linear``, LeCun truncated normal (as ``layers.dense``)."""
    lin = nn.Linear(fan_in, fan_out, bias=False)
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(lin.weight, std=std, a=-2.0 * std, b=2.0 * std)
    return lin


class RMSNorm(nn.Module):
    """x / sqrt(mean(x^2) + eps) * weight, in float32 (float64 stays)."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = widen(x)
        return self.weight * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps))


class SwiGLU(nn.Module):
    """down(silu(gate(x)) * up(x))."""

    def __init__(self, dim: int, width: int):
        super().__init__()
        self.gate_proj = _linear(dim, width)
        self.up_proj = _linear(dim, width)
        self.down_proj = _linear(width, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class MLA(nn.Module):
    """Multi-head latent attention without q-LoRA, over all points (no
    mask, no rotation); the logits' softmax in float32.  The core,
    softmax(s q k^T) v, is ``ops/mla_attention_cuda.attention`` on the
    projections' outputs as they lie: on the card hand-written kernels (one
    launch forward, two backward) that never write the logits, on the CPU
    the plain chain."""

    def __init__(self, cfg: DeepSeekV2Config):
        super().__init__()
        d, h = cfg.hidden_size, cfg.num_attention_heads
        self.cfg = cfg
        self.q_proj = _linear(d, h * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim))
        self.kv_a_proj_with_mqa = _linear(d, cfg.kv_lora_rank + cfg.qk_rope_head_dim)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps)
        self.kv_b_proj = _linear(cfg.kv_lora_rank, h * (cfg.qk_nope_head_dim + cfg.v_head_dim))
        self.o_proj = _linear(h * cfg.v_head_dim, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        b, n, _ = x.shape
        h, nope, rope = c.num_attention_heads, c.qk_nope_head_dim, c.qk_rope_head_dim
        q = self.q_proj(x).view(b, n, h, nope + rope)
        latent, k_pe = self.kv_a_proj_with_mqa(x).split([c.kv_lora_rank, rope], dim=-1)
        kv = self.kv_b_proj(self.kv_a_layernorm(latent)).view(b, n, h, nope + c.v_head_dim)
        o = mla_attention.attention(q, kv, k_pe, c.softmax_scale)
        return self.o_proj(o.reshape(b, n, h * c.v_head_dim))


class DeepSeekMoE(nn.Module):
    """The MoE FFN of layer ``index``: a top-k router over all
    ``n_routed_experts`` (softmax, or sigmoid with the correction bias), the
    held experts' SwiGLUs (``gate_up`` (held, d, 2 f): gate then up;
    ``down`` (held, f, d)) and the shared experts.  After a forward
    ``aux_loss`` is the sequence-wise balance loss (unweighted; None where
    ``aux_loss_alpha`` is 0) and ``expert_frac`` (E,) the share of the
    choices each expert got."""

    def __init__(self, cfg: DeepSeekV2Config, index: int):
        super().__init__()
        d, f = cfg.hidden_size, cfg.moe_intermediate_size
        self.cfg, self.span = cfg, f"moe.l{index}"
        self.gate = nn.Parameter(_linear(d, cfg.n_routed_experts).weight.detach())
        self.gate_up = nn.Parameter(_lecun_normal_stacked((cfg.experts_held, d, 2 * f)))
        self.down = nn.Parameter(_lecun_normal_stacked((cfg.experts_held, f, d)))
        self.shared_experts = SwiGLU(d, f * cfg.n_shared_experts)
        self.sigmoid = cfg.scoring_func == "sigmoid"
        if cfg.scoring_func not in ("softmax", "sigmoid"):
            raise ValueError(f"scoring_func {cfg.scoring_func!r}: softmax or sigmoid")
        if self.sigmoid:
            self.register_buffer("e_score_correction_bias", torch.zeros(cfg.n_routed_experts))
        self.aux_loss: torch.Tensor | None = None
        self.expert_frac: torch.Tensor | None = None
        self.choice_counts: torch.Tensor | None = None  # (E,) the last forward's choices of each expert
        self._tally: dict = {}  # (device, T) -> (1, held, rows_even) for the device counters, made outside a capture

    def route(self, tokens: torch.Tensor):
        """(scores (T, E), weights (T, k), experts (T, k)): the float32
        softmax (or sigmoid) over all experts, its top k (by score plus the
        correction bias) and their scaled (renormalised) scores."""
        cfg = self.cfg
        with torch.autocast(tokens.device.type, enabled=False):
            logits = F.linear(tokens.float(), self.gate.float())
            if self.sigmoid:
                probs = torch.sigmoid(logits)
                top_i = torch.topk(probs + self.e_score_correction_bias, cfg.num_experts_per_tok, dim=-1)[1]
                top_w = probs.gather(-1, top_i)
            else:
                probs = torch.softmax(logits, dim=-1)
                top_w, top_i = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
        if cfg.norm_topk_prob:
            top_w = top_w / top_w.sum(-1, keepdim=True)
        return probs, top_w * cfg.routed_scaling_factor, top_i

    def count_choices(self, top_i: torch.Tensor) -> None:
        """``choice_counts`` (E,) and ``expert_frac`` from the choices
        (no atomic adds)."""
        e = self.cfg.n_routed_experts
        self.choice_counts = (top_i.reshape(-1, 1) == torch.arange(e, device=top_i.device)).sum(0)
        self.expert_frac = self.choice_counts / top_i.numel()

    def after_step(self, groups: tuple = ()) -> None:
        """The correction bias's move after an optimizer step, from the
        last forward's choices summed over ``groups`` (the process groups
        whose ranks route other tokens through the same experts, so that
        their biases stay equal): b_i += speed sign(c - c_i), c the mean,
        taken as sign(T k - E c_i) in integers."""
        if not self.sigmoid:
            return
        c = self.choice_counts
        if groups:
            c = c.clone()
            for group in groups:
                dist.all_reduce(c, group=group)
        move = torch.sign(c.sum() - c * self.cfg.n_routed_experts) * self.cfg.bias_update_speed
        self.e_score_correction_bias.add_(move)

    def balance_loss(self, probs: torch.Tensor, top_i: torch.Tensor, clouds: int) -> torch.Tensor:
        """mean_b sum_i f_bi P_bi over all E experts; also sets ``expert_frac``."""
        e, k = self.cfg.n_routed_experts, top_i.shape[1]
        n = probs.shape[0] // clouds
        chosen = (top_i[..., None] == torch.arange(e, device=top_i.device)).view(clouds, n * k, e)
        count = chosen.sum(dim=1).to(probs.dtype)  # (B, E): the cloud's choices of each expert
        self.expert_frac = count.sum(dim=0) / (clouds * n * k)
        f = count * (e / (k * n))
        return torch.mean(torch.sum(f * probs.view(clouds, n, e).mean(dim=1), dim=-1))

    def _held_experts(self, tokens: torch.Tensor, top_w: torch.Tensor, top_i: torch.Tensor) -> torch.Tensor:
        """sum over each token's held choices of s_i E_i(x): (T, d) float32."""
        cfg = self.cfg
        held, dev = cfg.experts_held, tokens.device
        order, inv, counts, offs = moe_rows.dispatch_plan(top_i, cfg.first_expert, held)
        t, k = top_i.shape
        tally = self._tally.get((dev, t))
        if tally is None:
            tally = self._tally[(dev, t)] = torch.tensor([1, held, t * k * held // cfg.n_routed_experts],
                                                         device=dev)
        obs.device_count(("moe.rows", "moe.rows_max", "moe.layer_steps", "moe.experts_held", "moe.rows_even"),
                         torch.cat((counts.sum(0, keepdim=True), counts.amax(0, keepdim=True), tally)))
        dt = torch.get_autocast_dtype(dev.type) if torch.is_autocast_enabled(dev.type) else tokens.dtype
        xs = moe_rows.gather(tokens, order, inv, offs, dt)
        h = moe_rows.swiglu(torch._grouped_mm(xs, self.gate_up.to(dt), offs=offs), offs)
        ys = torch._grouped_mm(h, self.down.to(dt), offs=offs)
        return moe_rows.combine(ys, top_w, inv, offs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        with obs.capture_count("moe"), obs.span(self.span, flush=True):
            tokens = x.reshape(b * n, d)
            probs, top_w, top_i = self.route(tokens)
            if self.cfg.aux_loss_alpha:
                self.aux_loss = self.balance_loss(probs, top_i, b)
            if self.sigmoid:
                self.count_choices(top_i)
            return self.shared_experts(x) + self._held_experts(tokens, top_w, top_i).view(b, n, d)


class DeepSeekV2Layer(nn.Module):
    """Pre-norm MLA, then the dense SwiGLU (layers below
    ``first_k_dense_replace``) or the MoE FFN."""

    def __init__(self, cfg: DeepSeekV2Config, index: int):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = MLA(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.dense = index < cfg.first_k_dense_replace
        self.mlp = SwiGLU(cfg.hidden_size, cfg.intermediate_size) if self.dense else DeepSeekMoE(cfg, index)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x + self.self_attn(self.input_layernorm(x))
        if not self.dense:
            return h + self.mlp(self.post_attention_layernorm(h))
        with obs.span("ffn.dense", flush=True):
            return h + self.mlp(self.post_attention_layernorm(h))


class DeepSeekV2Trunk(nn.Module):
    """``num_hidden_layers`` layers and a final RMSNorm: (B, N, d) ->
    (B, N, d) float32."""

    def __init__(self, cfg: DeepSeekV2Config):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(DeepSeekV2Layer(cfg, i) for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return self.norm(x)

    def moe_layers(self) -> list:
        return [layer.mlp for layer in self.layers if not layer.dense]
