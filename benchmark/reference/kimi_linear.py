"""PlaneNet with Kimi Linear's hybrid block as its trunk (the aircraft
denoiser of the ``planenet_kimi`` family), written from the published
description: "Kimi Linear" (arXiv:2510.26692), FLA's ``naive_recurrent_kda``
and the keys of Kimi-Linear-48B-A3B's ``config.json``.

Per trunk layer, x (B, N, d), no biases unless stated:

    h = x + Mixer(RMSNorm(x));  out = h + FFN(RMSNorm(h))

The mixer of layer i (from 0) is MLA where i + 1 is in ``full_attn_layers``
(``dsv2.mla`` with softmax scale (nope + rope)^-1/2, nothing rotated),
else Kimi Delta Attention, H heads of dk = dv dims: q, k, v =
silu(conv(W x)) with a depthwise causal convolution of
``short_conv_kernel_size`` taps over the points in stored order (y_t =
sum_i w[:, i] x_{t - K + 1 + i}, zero before the first point); q, k
L2-normalised per head (x / sqrt(sum x^2 + 1e-6)), q times dk^-1/2; g =
-exp(A_log_h) softplus(W_fb W_fa x + dt_bias); beta = sigmoid(W_b x); the
recurrence token by token from S = 0:

    S <- Diag(exp(g_t)) S;  S <- S + beta_t k_t (v_t - S^T k_t)^T;  o_t = S^T q_t

then o = RMSNorm_dv(o) * sigmoid(W_gb W_ga x + b_g) per head and W_o o.
FFN of the first ``first_k_dense_replace`` layers: ``dsv2.swiglu``.  The
others: s = sigmoid(W_g x) over all E experts, the top k of s + b (b the
layer's correction bias), weights ``routed_scaling_factor`` s_i / sum of
the top k's s, and Shared(x) + sum over the top k of the held experts of
w_i E_i(x), a plain loop over the held experts (those from
``first_expert`` on: an expert-parallel rank's share).  A final RMSNorm,
then PlaneNet's gated pool and head.  The correction bias is the caller's:
``forward`` takes one (E,) tensor a MoE layer and returns each layer's
count of choices, and ``update_bias`` moves it as the program does after a
step.

Departures from the language model, for a point set: KDA runs causally
over the points in stored order; MLA is unmasked and unrotated; PlaneNet's
SIREN + timestep embedding, pool and head in place of the token embedding
and the LM head.

Plain ``torch``.  Each trunk layer runs under ``torch.utils.checkpoint``
(recomputed in the backward) and the recurrence in checkpointed segments
of ``SEGMENT`` tokens, so that the float64 check fits on one card.  ``q``
rounds every product that the configuration runs in bf16 (``lowp``); the
router, the convolutions, the gates and the recurrence run unrounded in
the weights' dtype.  The cells call it in float64, where TF32 never
applies."""
from __future__ import annotations

import math

import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from . import nn
from .dsv2 import mla, proj, rms_norm, swiglu

SEGMENT = 64  # tokens of the recurrence between two kept states
L2_EPS = 1e-6


def _cfg(cfg: dict) -> dict:
    """The sizes the layers read, from a configuration's keys."""
    lin = cfg["linear_attn_config"]
    return dict(d=cfg["hidden_size"], heads=cfg["num_attention_heads"], nope=cfg["qk_nope_head_dim"],
                rope=cfg["qk_rope_head_dim"], v=cfg["v_head_dim"], rank=cfg["kv_lora_rank"],
                dense=cfg["intermediate_size"], f=cfg["moe_intermediate_size"], experts=cfg["num_experts"],
                k=cfg["num_experts_per_token"], shared=cfg["num_shared_experts"],
                first_moe=cfg["first_k_dense_replace"], layers=cfg["num_hidden_layers"], eps=cfg["rms_norm_eps"],
                scale_routed=cfg["routed_scaling_factor"], held=cfg["experts_held"],
                first=cfg.get("first_expert", 0), kda_heads=lin["num_heads"], kda_dim=lin["head_dim"],
                conv=lin["short_conv_kernel_size"], kda_layers=tuple(lin["kda_layers"]),
                speed=cfg["bias_update_speed"],
                softmax_scale=(cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5)


def _w(name: str, fan_out: int, fan_in: int) -> tuple:
    return (name + ".weight", (fan_out, fan_in), ("normal", 1.0 / math.sqrt(fan_in)))


def _rms_spec(name: str, dim: int) -> tuple:
    return (name + ".weight", (dim,), ("normal_around_one", 0.02))


def _swiglu_spec(name: str, d: int, width: int) -> list:
    return [_w(name + ".gate_proj", width, d), _w(name + ".up_proj", width, d), _w(name + ".down_proj", d, width)]


def kda_spec(name: str, c: dict) -> list:
    """KDA's leaves.  A_log N(0, 1) a head and dt_bias N(0, 3^2) a channel
    (the seeded draws have no offset): decays from ~e^-20 to ~1 a point, in
    every layer."""
    d, h, dk = c["d"], c["kda_heads"], c["kda_dim"]
    width = h * dk
    spec = []
    for part in ("q", "k", "v"):
        spec += [_w(f"{name}.{part}_proj", width, d),
                 (f"{name}.{part}_conv1d.weight", (width, c["conv"]), ("normal", 1.0 / math.sqrt(c["conv"])))]
    return spec + [(name + ".A_log", (h,), ("normal", 1.0)),
                   _w(name + ".f_a_proj", dk, d), _w(name + ".f_b_proj", width, dk),
                   (name + ".dt_bias", (width,), ("normal", 3.0)),
                   _w(name + ".b_proj", h, d), _w(name + ".g_a_proj", dk, d), _w(name + ".g_b_proj", width, dk),
                   (name + ".g_b_proj.bias", (width,), ("normal", 0.02)), _rms_spec(name + ".o_norm", dk),
                   _w(name + ".o_proj", d, width)]


def param_spec(cfg: dict) -> list:
    c = _cfg(cfg)
    d, h = c["d"], c["heads"]
    spec = nn.siren_spec("siren", 3, d // 2, 30.0)
    for i in range(c["layers"]):
        p = f"encoder.layers.{i}"
        spec.append(_rms_spec(p + ".input_layernorm", d))
        if i + 1 in c["kda_layers"]:
            spec += kda_spec(p + ".self_attn", c)
        else:
            spec += [_w(p + ".self_attn.q_proj", h * (c["nope"] + c["rope"]), d),
                     _w(p + ".self_attn.kv_a_proj_with_mqa", c["rank"] + c["rope"], d),
                     _rms_spec(p + ".self_attn.kv_a_layernorm", c["rank"]),
                     _w(p + ".self_attn.kv_b_proj", h * (c["nope"] + c["v"]), c["rank"]),
                     _w(p + ".self_attn.o_proj", d, h * c["v"])]
        spec.append(_rms_spec(p + ".post_attention_layernorm", d))
        if i < c["first_moe"]:
            spec += _swiglu_spec(p + ".mlp", d, c["dense"])
        else:
            f = c["f"]
            spec += [(p + ".mlp.gate", (c["experts"], d), ("normal", 1.0 / math.sqrt(d))),
                     (p + ".mlp.gate_up", (c["held"], d, 2 * f), ("normal", 1.0 / math.sqrt(d))),
                     (p + ".mlp.down", (c["held"], f, d), ("normal", 1.0 / math.sqrt(f)))]
            spec += _swiglu_spec(p + ".mlp.shared_experts", d, f * c["shared"])
    spec.append(_rms_spec("encoder.norm", d))
    spec += nn.dense_spec("pool.gate", d, 1) + nn.dense_spec("pool.val", d, d)
    return spec + nn.dense_spec("head", d, 3)


def short_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """silu of the causal depthwise convolution of (B, N, C) x with (C, K) w."""
    n, width = x.shape[1], w.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    return F.silu(sum(xp[:, i:i + n] * w[:, i] for i in range(width)))


def _segment(s, q, k, v, g, beta):
    """The recurrence over a segment of (B, H, L, .) tokens from state s
    (B, H, dk, dv): (the state after, o (B, H, L, dv))."""
    outs = []
    for t in range(q.shape[2]):
        s = s * torch.exp(g[:, :, t])[..., None]
        kt = k[:, :, t]
        pred = (kt[..., None, :] @ s)[..., 0, :]  # S^T k
        s = s + beta[:, :, t, None, None] * kt[..., None] * (v[:, :, t] - pred)[..., None, :]
        outs.append((q[:, :, t, None, :] @ s)[..., 0, :])
    return s, torch.stack(outs, 2)


def recurrent_kda(q, k, v, g, beta, segment: int = SEGMENT) -> torch.Tensor:
    """The gated delta rule token by token over (B, H, N, dk) q, k, g, (B, H,
    N, dv) v and (B, H, N) beta from S = 0: o (B, H, N, dv); with gradients
    on, each segment of ``segment`` tokens is recomputed in the backward."""
    b, h, n, dk = q.shape
    s = q.new_zeros(b, h, dk, v.shape[-1])
    outs = []
    for lo in range(0, n, segment):
        part = tuple(x[:, :, lo:lo + segment] for x in (q, k, v, g, beta))
        if torch.is_grad_enabled():
            s, o = checkpoint(_segment, s, *part, use_reentrant=False)
        else:
            s, o = _segment(s, *part)
        outs.append(o)
    return torch.cat(outs, 2)


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + L2_EPS)


def kda(p: dict, name: str, x: torch.Tensor, c: dict, q=None, recurrence=recurrent_kda) -> torch.Tensor:
    b, n, _ = x.shape
    h, dk = c["kda_heads"], c["kda_dim"]

    def heads(y):
        return y.reshape(b, n, h, -1).transpose(1, 2)

    qh, kh, vh = (heads(short_conv(proj(p, f"{name}.{part}_proj", x, q), p[f"{name}.{part}_conv1d.weight"]))
                  for part in ("q", "k", "v"))
    qh, kh = _l2norm(qh) * dk ** -0.5, _l2norm(kh)
    f = proj(p, name + ".f_b_proj", proj(p, name + ".f_a_proj", x, q), q).reshape(b, n, h, dk)
    g = -torch.exp(p[name + ".A_log"])[:, None] * F.softplus(f + p[name + ".dt_bias"].reshape(h, dk))
    beta = torch.sigmoid(proj(p, name + ".b_proj", x, q)).transpose(1, 2)
    o = recurrence(qh, kh, vh, g.transpose(1, 2), beta).transpose(1, 2)
    gate = proj(p, name + ".g_b_proj", proj(p, name + ".g_a_proj", x, q), q) + p[name + ".g_b_proj.bias"]
    o = rms_norm(p, name + ".o_norm", o, c["eps"]) * torch.sigmoid(gate).reshape(b, n, h, dk)
    return proj(p, name + ".o_proj", o.reshape(b, n, h * dk), q)


def route(p: dict, name: str, tokens: torch.Tensor, bias: torch.Tensor, c: dict):
    """(the top k's weights (T, k), their experts (T, k)): sigmoid scores,
    chosen by score plus ``bias``, renormalised and scaled."""
    scores = torch.sigmoid(tokens @ p[name + ".gate"].T)
    top_i = torch.topk(scores + bias.to(scores.dtype), c["k"], dim=-1)[1]
    top_w = scores.gather(-1, top_i)
    return top_w / top_w.sum(-1, keepdim=True) * c["scale_routed"], top_i


def moe(p: dict, name: str, x: torch.Tensor, bias: torch.Tensor, c: dict, q=None):
    """(the layer's output: the shared expert plus the held experts' part,
    each expert's count of choices (E,))."""
    b, n, d = x.shape
    tokens = x.reshape(b * n, d)
    top_w, top_i = route(p, name, tokens, bias, c)
    out = swiglu(p, name + ".shared_experts", tokens, q)
    f = c["f"]
    for j in range(c["held"]):
        chose = top_i == c["first"] + j  # (T, k): a token chooses an expert at most once
        rows = torch.nonzero(chose.any(-1))[:, 0]
        if rows.numel() == 0:
            continue
        weight = (top_w * chose).sum(-1)[rows]
        hid = nn.matmul(tokens[rows], p[name + ".gate_up"][j], q)
        act = F.silu(hid[:, :f]) * hid[:, f:]
        out = out.index_add(0, rows, nn.matmul(act, p[name + ".down"][j], q) * weight[:, None])
    return out.reshape(b, n, d), torch.bincount(top_i.reshape(-1), minlength=c["experts"])


def update_bias(bias: torch.Tensor, counts: torch.Tensor, c: dict) -> torch.Tensor:
    """The bias after a step: b_i + speed sign(mean count - c_i)."""
    mean = counts.sum().double() / counts.numel()
    return bias + c["speed"] * torch.sign(mean - counts.double()).to(bias.dtype)


def _layer(p: dict, i: int, h: torch.Tensor, bias, c: dict, q, recurrence):
    pre = f"encoder.layers.{i}"
    y = rms_norm(p, pre + ".input_layernorm", h, c["eps"])
    if i + 1 in c["kda_layers"]:
        h = h + kda(p, pre + ".self_attn", y, c, q, recurrence)
    else:
        h = h + mla(p, pre + ".self_attn", y, c, q)
    y = rms_norm(p, pre + ".post_attention_layernorm", h, c["eps"])
    if i < c["first_moe"]:
        return h + swiglu(p, pre + ".mlp", y, q), None
    out, counts = moe(p, pre + ".mlp", y, bias, c, q)
    return h + out, counts


def forward(p: dict, cfg: dict, x: torch.Tensor, t: torch.Tensor, biases: list, q=None,
            recurrence=recurrent_kda):
    """x (B, N, 3) rotated clouds, t (B,) timesteps, ``biases`` one (E,)
    correction bias a MoE layer -> ((B, 3), each MoE layer's count of
    choices)."""
    c = _cfg(cfg)
    half = c["d"] // 2
    emb = nn.siren(p, "siren", x)
    h = torch.cat((emb, nn.sinusoidal(t, half, x.dtype)[:, None, :].expand_as(emb)), -1)
    counts = []
    for i in range(c["layers"]):
        bias = biases[i - c["first_moe"]] if i >= c["first_moe"] else None
        if torch.is_grad_enabled():
            h, n = checkpoint(_layer, p, i, h, bias, c, q, recurrence, use_reentrant=False)
        else:
            h, n = _layer(p, i, h, bias, c, q, recurrence)
        if n is not None:
            counts.append(n)
    h = rms_norm(p, "encoder.norm", h, c["eps"])
    pooled = nn.gated_mean(p, "pool", h, nn.linear(p, "pool.val", h))[:, 0]
    return nn.linear(p, "head", pooled), counts
