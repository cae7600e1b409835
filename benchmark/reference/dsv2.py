"""PlaneNet with DeepSeek-V2's block as its trunk (the aircraft denoiser of
the ``planenet_dsv2`` family), written from the published description:
DeepSeek-V2 (arXiv:2405.04434) and the keys of its ``config.json``.

Per trunk layer, x (B, N, d), no biases:

    h = x + MLA(RMSNorm(x));  out = h + FFN(RMSNorm(h))

RMSNorm: x / sqrt(mean(x^2) + eps) * w.  MLA: q = W_q x (H heads of nope +
rope dims); [c, k_pe] = W_kva x, c = RMSNorm(c); [k_nope, v] = W_kvb c (H
heads of nope + v dims); k = [k_nope, k_pe for every head]; o =
softmax(q k^T s) v over all N points, s = (nope + rope)^-1/2 m^2, m = 0.1
mscale_all_dim ln(factor) + 1 (YaRN's); W_o o.  FFN of the first
``first_k_dense_replace`` layers: W_down(silu(W_gate x) * W_up x).  The
other layers: scores s = softmax(W_g x) over all E experts, the top k by
score with weights s_i (not renormalised) times ``routed_scaling_factor``,
and Shared(x) + sum over the top k of the held experts of s_i E_i(x), each
expert a SwiGLU (``gate_up`` (held, d, 2 f): gate then up; ``down`` (held,
f, d)), the held experts those from ``first_expert`` on (an
expert-parallel rank's share: the absent experts' part is left out).  The
balance loss of a layer, per cloud b of N points: f_bi = E / (k N) #{t in
b: i in topk(t)}, P_bi = mean_t s_ti, mean_b sum_i f_bi P_bi; the model's
is the sum over the layers.  A final RMSNorm, then PlaneNet's gated pool
and head.

Departures from the language model, for a point set: no rotary rotation
(q_pe and k_pe unrotated, the rotation at position 0), no causal mask, and
PlaneNet's SIREN + timestep embedding, pool and head in place of the token
embedding and the LM head.

Plain ``torch``: the routed experts run as a loop over the held experts on
the rows that chose each.  ``q`` rounds every product of the region the
configuration runs in bf16 (``lowp``); the router runs unrounded, in the
weights' dtype.  The cells call it in float64, where TF32 never applies."""
from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from . import nn


def _cfg(cfg: dict) -> dict:
    """The sizes the layers read, from a configuration's keys."""
    rope = cfg["rope_scaling"]
    m = 0.1 * rope["mscale_all_dim"] * math.log(rope["factor"]) + 1.0 if rope["factor"] > 1 else 1.0
    return dict(d=cfg["hidden_size"], heads=cfg["num_attention_heads"], nope=cfg["qk_nope_head_dim"],
                rope=cfg["qk_rope_head_dim"], v=cfg["v_head_dim"], rank=cfg["kv_lora_rank"],
                dense=cfg["intermediate_size"], f=cfg["moe_intermediate_size"], experts=cfg["n_routed_experts"],
                k=cfg["num_experts_per_tok"], shared=cfg["n_shared_experts"], first_moe=cfg["first_k_dense_replace"],
                layers=cfg["num_hidden_layers"], eps=cfg["rms_norm_eps"], scale_routed=cfg["routed_scaling_factor"],
                held=cfg["experts_held"], first=cfg.get("first_expert", 0),
                softmax_scale=(cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5 * m * m)


def _w(name: str, fan_out: int, fan_in: int) -> tuple:
    return (name + ".weight", (fan_out, fan_in), ("normal", 1.0 / math.sqrt(fan_in)))


def _rms_spec(name: str, dim: int) -> tuple:
    return (name + ".weight", (dim,), ("normal_around_one", 0.02))


def _swiglu_spec(name: str, d: int, width: int) -> list:
    return [_w(name + ".gate_proj", width, d), _w(name + ".up_proj", width, d), _w(name + ".down_proj", d, width)]


def param_spec(cfg: dict) -> list:
    c = _cfg(cfg)
    d, h = c["d"], c["heads"]
    spec = nn.siren_spec("siren", 3, d // 2, 30.0)
    for i in range(c["layers"]):
        p = f"encoder.layers.{i}"
        spec += [_rms_spec(p + ".input_layernorm", d),
                 _w(p + ".self_attn.q_proj", h * (c["nope"] + c["rope"]), d),
                 _w(p + ".self_attn.kv_a_proj_with_mqa", c["rank"] + c["rope"], d),
                 _rms_spec(p + ".self_attn.kv_a_layernorm", c["rank"]),
                 _w(p + ".self_attn.kv_b_proj", h * (c["nope"] + c["v"]), c["rank"]),
                 _w(p + ".self_attn.o_proj", d, h * c["v"]),
                 _rms_spec(p + ".post_attention_layernorm", d)]
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


def rms_norm(p: dict, name: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    return p[name + ".weight"] * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def proj(p: dict, name: str, x: torch.Tensor, q=None) -> torch.Tensor:
    """x W^T of a bias-free layer."""
    return nn.matmul(x, p[name + ".weight"].T, q)


def swiglu(p: dict, name: str, x: torch.Tensor, q=None) -> torch.Tensor:
    hidden = F.silu(proj(p, name + ".gate_proj", x, q)) * proj(p, name + ".up_proj", x, q)
    return proj(p, name + ".down_proj", hidden, q)


def mla(p: dict, name: str, x: torch.Tensor, c: dict, q=None) -> torch.Tensor:
    b, n, _ = x.shape
    h, nope, rope = c["heads"], c["nope"], c["rope"]
    qh = proj(p, name + ".q_proj", x, q).reshape(b, n, h, nope + rope).transpose(1, 2)
    ckv = proj(p, name + ".kv_a_proj_with_mqa", x, q)
    latent, k_pe = ckv[..., :c["rank"]], ckv[..., c["rank"]:]
    kv = proj(p, name + ".kv_b_proj", rms_norm(p, name + ".kv_a_layernorm", latent, c["eps"]), q)
    kv = kv.reshape(b, n, h, nope + c["v"]).transpose(1, 2)
    k = torch.cat((kv[..., :nope], k_pe[:, None].expand(b, h, n, rope)), -1)
    logits = nn.matmul(qh, k.transpose(-1, -2), q) * c["softmax_scale"]
    o = nn.matmul(torch.softmax(logits, -1), kv[..., nope:], q)
    return proj(p, name + ".o_proj", o.transpose(1, 2).reshape(b, n, h * c["v"]), q)


def route(p: dict, name: str, tokens: torch.Tensor, c: dict):
    """(scores (T, E), the top k's scaled scores (T, k), their experts (T, k))."""
    scores = torch.softmax(tokens @ p[name + ".gate"].T, -1)
    top_w, top_i = torch.topk(scores, c["k"], dim=-1)
    return scores, top_w * c["scale_routed"], top_i


def balance_loss(scores: torch.Tensor, top_i: torch.Tensor, clouds: int, c: dict) -> torch.Tensor:
    e, k = c["experts"], c["k"]
    n = scores.shape[0] // clouds
    count = torch.zeros(clouds, e, dtype=scores.dtype, device=scores.device)
    for b in range(clouds):
        count[b] = torch.bincount(top_i[b * n:(b + 1) * n].reshape(-1), minlength=e).to(scores.dtype)
    f = count * e / (k * n)
    return (f * scores.reshape(clouds, n, e).mean(1)).sum(-1).mean()


def moe(p: dict, name: str, x: torch.Tensor, c: dict, q=None):
    """(the layer's output: the shared experts plus the held experts'
    part, the layer's balance loss)."""
    b, n, d = x.shape
    tokens = x.reshape(b * n, d)
    scores, top_w, top_i = route(p, name, tokens, c)
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
    return out.reshape(b, n, d), balance_loss(scores, top_i, b, c)


def forward(p: dict, cfg: dict, x: torch.Tensor, t: torch.Tensor, q=None):
    """x (B, N, 3) rotated clouds, t (B,) -> ((B, 3), the balance loss
    summed over the MoE layers)."""
    c = _cfg(cfg)
    half = c["d"] // 2
    emb = nn.siren(p, "siren", x)
    h = torch.cat((emb, nn.sinusoidal(t, half, x.dtype)[:, None, :].expand_as(emb)), -1)
    aux = torch.zeros((), dtype=x.dtype, device=x.device)
    for i in range(c["layers"]):
        pre = f"encoder.layers.{i}"
        h = h + mla(p, pre + ".self_attn", rms_norm(p, pre + ".input_layernorm", h, c["eps"]), c, q)
        y = rms_norm(p, pre + ".post_attention_layernorm", h, c["eps"])
        if i < c["first_moe"]:
            h = h + swiglu(p, pre + ".mlp", y, q)
        else:
            out, layer_aux = moe(p, pre + ".mlp", y, c, q)
            h, aux = h + out, aux + layer_aux
    h = rms_norm(p, "encoder.norm", h, c["eps"])
    pooled = nn.gated_mean(p, "pool", h, nn.linear(p, "pool.val", h))[:, 0]
    return nn.linear(p, "head", pooled), aux
