"""Kimi Linear's hybrid decoder block as a trunk over a point set (no
counterpart in the JAX package): RMSNorm pre-norm layers whose token mixer
is Kimi Delta Attention (KDA, a gated delta-rule linear attention) in three
layers of four and multi-head latent attention (MLA) in the fourth, with a
dense SwiGLU in the first ``first_k_dense_replace`` layers and a
sigmoid-routed DeepSeekMoE after them (Kimi Team 2025, "Kimi Linear",
arXiv:2510.26692), under the keys and sizes of the published
``config.json`` of Kimi-Linear-48B-A3B.

A layer, x (B, N, d), no biases unless stated:

    h = x + Mixer(RMSNorm(x));  out = h + FFN(RMSNorm(h))

The mixer of layer i (counted from 0) is MLA where i + 1 is in
``full_attn_layers`` and KDA otherwise.  KDA, H heads of dk = dv dims:

    q, k, v = SiLU(Conv(W_q x)), SiLU(Conv(W_k x)), SiLU(Conv(W_v x))

each Conv depthwise over the N points in stored order, ``short_conv_kernel_size``
wide, bias-free, zero-padded on the left (causal); q and k L2-normalised per
head (x / sqrt(sum x^2 + 1e-6), FLA's ``l2norm``), q scaled by dk^-1/2; the
per-channel log-decay g = -exp(A_log[h]) softplus(W_fb W_fa x + dt_bias)
(H dk wide, rank dv); beta = sigmoid(W_b x), one a head; per head the state
S (dk, dv) starts at 0 and for t = 1 .. N

    S <- Diag(exp(g_t)) S;  S <- S + beta_t k_t (v_t - S^T k_t)^T;  o_t = S^T q_t

then o = RMSNorm_dv(o) * sigmoid(W_gb W_ga x + b_g) per head (rank dv, the
one bias b_g) and the output W_o o.  MLA is ``deepseek_v2.MLA`` without a
rotation (``mla_use_nope``) at softmax scale (nope + rope)^-1/2.  The MoE
FFN is ``deepseek_v2.DeepSeekMoE`` with sigmoid scores: s = sigmoid(W_g x)
over all E experts, the top k of s + b (b the layer's correction bias, a
buffer), weights ``routed_scaling_factor`` s_i / sum of the top k's s, one
shared expert; b moves by ``bias_update_speed`` sign(mean - c_i) after each
optimizer step (c_i expert i's choices in the step), and there is no
balance loss (``aux_loss_alpha`` 0).  A final RMSNorm closes the trunk.

The recurrence runs in chunkwise form (``chunk_kda``; the WY / UT form of
the KDA paper and FLA's ``chunk_kda``): within a chunk of ``chunk_size``
points the intra-chunk products come from cumulative log-decays G, every
decay a difference of them, later minus earlier, so that every ``exp``
takes a non-positive argument; between chunks the state is carried by one
product a chunk.  Gates, G and the state are float32, and so are all its
products (autocast is off inside).  On the card it is a hand-written kernel
pair (``ops/kda_cuda.py``: two launches forward, four backward, reading q,
k, v, g and beta at the strides the mixer leaves them and writing o as (B,
N, H, dv)); on the CPU the plain version (``chunk_kda_ref``: ``_chunks``,
recomputed in the backward under ``torch.utils.checkpoint`` rather than
kept).  Shapes are static, nothing is read on the host, so a train step
holding it is captured in a CUDA graph.

Departures from the language model, for a point set: KDA and its
convolutions run causally over the points in their stored order (the
trunk is not invariant to a permutation of the points); MLA is unmasked and
nothing is rotated; PlaneNet's embedding, pool and head stand in for the
token embedding and the LM head.

Spans (``obs``): ``kda.l<i>`` around the KDA mixer of layer i (stamped at
its end); the dense FFN's ``ffn.dense`` and the MoE layers' ``moe.l<i>``
as in the DeepSeek-V2 trunk.  At a capture ``kda.graph_kernels`` counts
the graph nodes the KDA mixers' forwards add and ``kda.captures`` the
forwards captured.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from .. import obs
from ..ops import kda_cuda
from .deepseek_v2 import MLA, DeepSeekMoE, DeepSeekV2Config, RMSNorm, SwiGLU, _linear

__all__ = ["KimiLinearConfig", "KIMI_LINEAR_48B", "TRUNKS", "ShortConv", "KimiDeltaAttention", "chunk_kda",
           "chunk_kda_ref", "KimiLinearLayer", "KimiLinearTrunk"]

L2_EPS = 1e-6  # FLA's l2norm


@dataclass(frozen=True)
class KimiLinearConfig:
    """The trunk's sizes, under the keys of the published ``config.json``
    (``linear_attn_config``'s ``num_heads``, ``head_dim``,
    ``short_conv_kernel_size``, ``kda_layers`` and ``full_attn_layers``
    flattened, the layers counted from 1); ``experts_held`` /
    ``first_expert`` the routed experts this layer holds,
    ``bias_update_speed`` the correction bias's step, ``chunk_size`` the
    chunk of the chunkwise recurrence."""

    hidden_size: int = 2304
    intermediate_size: int = 9216
    moe_intermediate_size: int = 1024
    num_experts: int = 256
    num_experts_per_token: int = 8
    num_shared_experts: int = 1
    first_k_dense_replace: int = 1
    num_hidden_layers: int = 27
    rms_norm_eps: float = 1e-5
    routed_scaling_factor: float = 2.446
    num_attention_heads: int = 32
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    linear_attn_num_heads: int = 32
    linear_attn_head_dim: int = 128
    short_conv_kernel_size: int = 4
    kda_layers: tuple = (1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19, 21, 22, 23, 25, 26)
    full_attn_layers: tuple = (4, 8, 12, 16, 20, 24, 27)
    aux_loss_alpha: float = 0.0
    bias_update_speed: float = 0.001
    experts_held: int = 256
    first_expert: int = 0
    chunk_size: int = 64

    def is_kda(self, index: int) -> bool:
        """Layer ``index`` (from 0) mixes with KDA, else with MLA."""
        if (index + 1 in self.kda_layers) == (index + 1 in self.full_attn_layers):
            raise ValueError(f"layer {index + 1} is in neither or both of kda_layers and full_attn_layers")
        return index + 1 in self.kda_layers

    def deepseek(self) -> DeepSeekV2Config:
        """The MLA and MoE layers' sizes as ``DeepSeekV2Config`` keys:
        sigmoid scores selected with the correction bias, renormalised, no
        rotation (softmax scale (nope + rope)^-1/2)."""
        return DeepSeekV2Config(
            hidden_size=self.hidden_size, num_attention_heads=self.num_attention_heads,
            qk_nope_head_dim=self.qk_nope_head_dim, qk_rope_head_dim=self.qk_rope_head_dim,
            v_head_dim=self.v_head_dim, kv_lora_rank=self.kv_lora_rank, intermediate_size=self.intermediate_size,
            moe_intermediate_size=self.moe_intermediate_size, n_routed_experts=self.num_experts,
            num_experts_per_tok=self.num_experts_per_token, n_shared_experts=self.num_shared_experts,
            first_k_dense_replace=self.first_k_dense_replace, num_hidden_layers=self.num_hidden_layers,
            rms_norm_eps=self.rms_norm_eps, routed_scaling_factor=self.routed_scaling_factor,
            aux_loss_alpha=self.aux_loss_alpha, rope_factor=1.0, experts_held=self.experts_held,
            first_expert=self.first_expert, scoring_func="sigmoid", norm_topk_prob=True,
            bias_update_speed=self.bias_update_speed)


# Kimi-Linear-48B-A3B (huggingface.co/moonshotai/Kimi-Linear-48B-A3B-Instruct, config.json)
KIMI_LINEAR_48B = KimiLinearConfig()
# the trunks the aircraft driver's --trunk names: one expert-parallel rank of
# 32 (8 of the 256 experts of every MoE layer), the published layers 1-5
# (KDA + dense, then KDA, KDA, MLA, KDA over MoE FFNs)
TRUNKS = {"kimilinear-ep32": replace(KIMI_LINEAR_48B, num_hidden_layers=5, experts_held=8)}


class ShortConv(nn.Module):
    """Depthwise causal convolution over the points, ``width`` wide and
    bias-free, then SiLU, in float32: y_t = silu(sum_i w[:, i] x_{t - width
    + 1 + i}), x zero before the first point.  ``weight`` (channels, width)."""

    def __init__(self, channels: int, width: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, width))
        nn.init.uniform_(self.weight, -width ** -0.5, width ** -0.5)  # nn.Conv1d's with one input channel

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, width = x.shape[1], self.weight.shape[1]
        xp = F.pad(x.float(), (0, 0, width - 1, 0))
        y = xp[:, :n] * self.weight[:, 0]
        for i in range(1, width):
            y = y + xp[:, i:i + n] * self.weight[:, i]
        return F.silu(y)


def _halves(x: torch.Tensor, blocks: int):
    """(..., C, d) -> the lower and upper halves of each of ``blocks``
    blocks: two (..., blocks, C / (2 blocks), d)."""
    return x.reshape(*x.shape[:-2], blocks, 2, -1, x.shape[-1]).unbind(-3)


def _join(lower: torch.Tensor, below: torch.Tensor, upper: torch.Tensor) -> torch.Tensor:
    """The block lower triangle [[lower, 0], [below, upper]] of (..., s, s)
    blocks: (..., 2s, 2s)."""
    top = torch.cat((lower, torch.zeros_like(lower)), -1)
    return torch.cat((top, torch.cat((below, upper), -1)), -2)


def _intra(q, k, G, beta):
    """The intra-chunk matrices of (..., C, d) chunks: P[i, j] = sum_c q_ic
    k_jc exp(G_ic - G_jc) for j <= i (0 above), and T = (I + A)^-1, A[i, j] =
    beta_i sum_c k_ic k_jc exp(G_ic - G_jc) for j < i.  Built by halving:
    the pairs across the middle of a block of 2s points factor through the
    cumulative decay G_r at the end of its lower half, exp(G_i - G_r)
    exp(G_r - G_j), both arguments non-positive; T's block is -T_U (beta_U
    X) T_L.  C a power of two."""
    c = q.shape[-2]
    P = (q * k).sum(-1)[..., None, None]  # the 1 x 1 diagonal blocks
    T = torch.ones_like(P)
    s = 1
    while s < c:
        blocks = c // (2 * s)
        (_, qU), (kL, kU), (GL, GU) = _halves(q, blocks), _halves(k, blocks), _halves(G, blocks)
        betaU = _halves(beta, blocks)[1]
        Gr = GL[..., -1:, :]
        eU = torch.exp(GU - Gr)
        X = torch.cat((qU * eU, kU * eU), -2) @ (kL * torch.exp(Gr - GL)).transpose(-1, -2)
        Xq, Xk = X.split(s, -2)
        PL, PU = P.reshape(*P.shape[:-3], blocks, 2, s, s).unbind(-3)
        TL, TU = T.reshape(*T.shape[:-3], blocks, 2, s, s).unbind(-3)
        P = _join(PL, Xq, PU)
        T = _join(TL, -(TU @ ((betaU * Xk) @ TL)), TU)
        s *= 2
    return P.reshape(*P.shape[:-3], c, c), T.reshape(*T.shape[:-3], c, c)


def _carry(M: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """The state at each chunk's start, (B, H, chunks, dk, dv): S_0 = 0,
    S_{n+1} = M_n S_n + R_n."""
    b, h, nc, dk, dv = R.shape
    Mf, Rf = M.reshape(b * h, nc, dk, dk), R.reshape(b * h, nc, dk, dv)
    s = torch.zeros_like(Rf[:, 0])
    states = [s]
    for i in range(nc - 1):
        s = torch.baddbmm(Rf[:, i], Mf[:, i], s)
        states.append(s)
    return torch.stack(states, 1).reshape(b, h, nc, dk, dv)


def _chunks(q, k, v, g, beta, chunk: int):
    b, h, n, dk = q.shape
    dv = v.shape[-1]
    pad = (-n) % chunk
    if pad:  # k = v = beta = g = 0 past the end: nothing added, nothing decayed
        q, k, v, g = (F.pad(x, (0, 0, 0, pad)) for x in (q, k, v, g))
        beta = F.pad(beta, (0, pad))
    nc = (n + pad) // chunk
    q, k, g = (x.reshape(b, h, nc, chunk, dk) for x in (q, k, g))
    v, beta = v.reshape(b, h, nc, chunk, dv), beta.reshape(b, h, nc, chunk, 1)
    G = g.cumsum(-2)
    P, T = _intra(q, k, G, beta)
    W = T @ (beta * k * torch.exp(G))  # U = T beta (V - K_G S) = U~ - W S
    U = T @ (beta * v)
    last = G[..., -1:, :]
    kd = (k * torch.exp(last - G)).transpose(-1, -2)  # to the chunk's end
    M = torch.diag_embed(torch.exp(last[..., 0, :])) - kd @ W
    S = _carry(M, kd @ U)
    o = P @ U + (q * torch.exp(G) - P @ W) @ S
    return o.reshape(b, h, nc * chunk, dv)[:, :, :n]


def chunk_kda_ref(q, k, v, g, beta, chunk: int = 64) -> torch.Tensor:
    """The plain version of ``chunk_kda``, as PyTorch ops: every operand and
    product in float32 (or float64, given float64); with gradients on, the
    chunk work is recomputed in the backward."""
    with torch.autocast(q.device.type, enabled=False):
        args = tuple(x.float() for x in (q, k, v, g, beta))
        if torch.is_grad_enabled() and any(x.requires_grad for x in args):
            return checkpoint(_chunks, *args, chunk, use_reentrant=False, preserve_rng_state=False)
        return _chunks(*args, chunk)


def chunk_kda(q, k, v, g, beta, chunk: int = 64) -> torch.Tensor:
    """The gated delta rule over (B, H, N, dk) q, k, g, (B, H, N, dv) v and
    (B, H, N) beta, in chunks of ``chunk`` (a power of two) points, every
    operand and product in float32: o (B, H, N, dv), o_t = S_t^T q_t of the
    recurrence in the module docstring from S_0 = 0.  CPU tensors take the
    plain version (``chunk_kda_ref``); CUDA tensors the hand-written kernels
    (``ops/kda_cuda.py``: float32, dk = dv of 128 or 32, chunks of 64), or
    raise."""
    if q.device.type == "cpu":
        return chunk_kda_ref(q, k, v, g, beta, chunk)
    return kda_cuda.chunk_kda(q, k, v, g, beta, chunk)


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + L2_EPS)


class KimiDeltaAttention(nn.Module):
    """KDA of layer ``index``: projections and convolutions, the gates, the
    chunkwise recurrence, the gated output norm and W_o."""

    def __init__(self, cfg: KimiLinearConfig, index: int):
        super().__init__()
        d, h, dk = cfg.hidden_size, cfg.linear_attn_num_heads, cfg.linear_attn_head_dim
        width, dv = h * dk, dk
        self.cfg, self.span = cfg, f"kda.l{index}"
        self.q_proj, self.k_proj, self.v_proj = _linear(d, width), _linear(d, width), _linear(d, width)
        self.q_conv1d, self.k_conv1d, self.v_conv1d = (ShortConv(width, cfg.short_conv_kernel_size)
                                                      for _ in range(3))
        self.A_log = nn.Parameter(torch.log(torch.empty(h).uniform_(1, 16)))  # FLA's
        self.f_a_proj, self.f_b_proj = _linear(d, dv), _linear(dv, width)
        dt = torch.exp(torch.empty(width).uniform_(math.log(1e-3), math.log(0.1)))
        self.dt_bias = nn.Parameter(dt + torch.log(-torch.expm1(-dt)))  # softplus(dt_bias) = dt
        self.b_proj = _linear(d, h)
        self.g_a_proj, self.g_b_proj = _linear(d, dv), nn.Linear(dv, h * dv)
        self.o_norm = RMSNorm(dv, cfg.rms_norm_eps)
        self.o_proj = _linear(h * dv, d)

    def decay(self, x: torch.Tensor) -> torch.Tensor:
        """The log-decay g (B, N, H, dk), float32, <= 0."""
        b, n, _ = x.shape
        h = self.cfg.linear_attn_num_heads
        f = self.f_b_proj(self.f_a_proj(x)).float().view(b, n, h, -1) + self.dt_bias.view(h, -1)
        return -torch.exp(self.A_log.float())[:, None] * F.softplus(f)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        b, n, _ = x.shape
        h = c.linear_attn_num_heads

        def heads(y):  # (B, N, H d) -> (B, H, N, d)
            return y.view(b, n, h, -1).transpose(1, 2)

        q = _l2norm(heads(self.q_conv1d(self.q_proj(x)))) * c.linear_attn_head_dim ** -0.5
        k = _l2norm(heads(self.k_conv1d(self.k_proj(x))))
        v = heads(self.v_conv1d(self.v_proj(x)))
        g = self.decay(x).transpose(1, 2)
        beta = torch.sigmoid(self.b_proj(x).float()).transpose(1, 2)
        o = chunk_kda(q, k, v, g, beta, c.chunk_size).transpose(1, 2)  # (B, N, H, dv)
        gate = torch.sigmoid(self.g_b_proj(self.g_a_proj(x)).float()).view(b, n, h, -1)
        return self.o_proj((self.o_norm(o) * gate).reshape(b, n, -1))


class KimiLinearLayer(nn.Module):
    """Pre-norm KDA or MLA, then the dense SwiGLU (layers below
    ``first_k_dense_replace``) or the MoE FFN."""

    def __init__(self, cfg: KimiLinearConfig, index: int):
        super().__init__()
        ds = cfg.deepseek()
        self.kda = cfg.is_kda(index)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = KimiDeltaAttention(cfg, index) if self.kda else MLA(ds)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.dense = index < cfg.first_k_dense_replace
        self.mlp = SwiGLU(cfg.hidden_size, cfg.intermediate_size) if self.dense else DeepSeekMoE(ds, index)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.input_layernorm(x)
        if self.kda:
            with obs.capture_count("kda"), obs.span(self.self_attn.span, flush=True):
                h = x + self.self_attn(y)
        else:
            h = x + self.self_attn(y)
        if not self.dense:
            return h + self.mlp(self.post_attention_layernorm(h))
        with obs.span("ffn.dense", flush=True):
            return h + self.mlp(self.post_attention_layernorm(h))


class KimiLinearTrunk(nn.Module):
    """``num_hidden_layers`` layers and a final RMSNorm: (B, N, d) ->
    (B, N, d) float32."""

    def __init__(self, cfg: KimiLinearConfig):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(KimiLinearLayer(cfg, i) for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return self.norm(x)

    def moe_layers(self) -> list:
        return [layer.mlp for layer in self.layers if not layer.dense]
