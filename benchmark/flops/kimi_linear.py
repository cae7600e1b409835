"""PlaneNet with the Kimi Linear trunk's forward, from a configuration's
keys.

``torch._grouped_mm``, which runs the held experts' products, has no
formula in FlopCounterMode and counts 0 there; ``counted`` is what
FlopCounterMode counts.  The routed rows depend on the routing, so the
held experts' products are counted at the expected rows: T k held / E
rows a layer, ``routed(cfg, rows)`` at any other count.  KDA's recurrence
is counted as the chunkwise form computes it (``kda``): its products grow
with the chunk, C, not with N."""
from __future__ import annotations


def kda(points: int, heads: int, dk: int, dv: int, chunk: int) -> float:
    """The chunked recurrence's products for one sequence of ``points``
    (padded to whole chunks), over all heads: per chunk the intra-chunk
    pairs level by level (blocks of s = 1, 2, ..., C/2 points, C / 2s of
    them a level: 4 s^2 dk for [q; k] against k, 4 s^3 for the inverse's
    block), T V and T K, K^T W and K^T U, P W and P U, the output's Q S;
    per chunk but the last the carried state's M S."""
    nc = -(-points // chunk)
    levels, s = 0, 1
    while s < chunk:
        levels += (chunk // (2 * s)) * (4 * s * s * dk + 4 * s ** 3)
        s *= 2
    per_chunk = levels + 4 * chunk * chunk * (dk + dv) + 2 * dk * chunk * (dk + dv) + 2 * chunk * dk * dv
    return float(heads * (nc * per_chunk + (nc - 1) * 2 * dk * dk * dv))


def _kda_layer(cfg: dict, index: int) -> bool:
    return index + 1 in cfg["linear_attn_config"]["kda_layers"]


def counted(cfg: dict, batch: int, points: int) -> float:
    """Per token the SIREN (3 -> d/2, d/2 -> d/2), the pool's gate and
    value; per KDA layer and token the q / k / v projections, the decay's
    and the output gate's low-rank pairs, beta's and W_o, per cloud its
    recurrence; per MLA layer and token MLA's four projections, QK^T and
    AV over all points; per layer the dense SwiGLU, or the router and the
    shared expert; per cloud the head."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, v, rank = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    lin = cfg["linear_attn_config"]
    kh, dk = lin["num_heads"], lin["head_dim"]
    f = cfg["moe_intermediate_size"]
    half, tokens = d // 2, batch * points
    per_token = 2 * (3 * half + half * half) + 2 * (d + d * d)
    mla = 2 * (d * h * (nope + rope) + d * (rank + rope) + rank * h * (nope + v) + h * v * d)
    mla += 2 * points * h * (nope + rope) + 2 * points * h * v
    kda_token = 2 * (3 * d * kh * dk + 2 * (d * dk + dk * kh * dk) + d * kh + kh * dk * d)
    per_cloud = 0.0
    for i in range(cfg["num_hidden_layers"]):
        if _kda_layer(cfg, i):
            per_token += kda_token
            per_cloud += kda(points, kh, dk, dk, cfg["chunk_size"])
        else:
            per_token += mla
        if i < cfg["first_k_dense_replace"]:
            per_token += 2 * 3 * d * cfg["intermediate_size"]
        else:
            per_token += 2 * d * cfg["num_experts"] + 2 * 3 * d * f * cfg["num_shared_experts"]
    return float(per_token * tokens + per_cloud * batch + 2 * 3 * d * batch)


def expected_rows(cfg: dict, batch: int, points: int) -> float:
    """The held experts' rows of one MoE layer at even routing."""
    return batch * points * cfg["num_experts_per_token"] * cfg["experts_held"] / cfg["num_experts"]


def routed(cfg: dict, rows: float) -> float:
    """The held experts' products over ``rows`` rows of every MoE layer."""
    moe_layers = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    return float(moe_layers * 2 * 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"] * rows)


def forward(cfg: dict, batch: int, points: int) -> float:
    return counted(cfg, batch, points) + routed(cfg, expected_rows(cfg, batch, points))
