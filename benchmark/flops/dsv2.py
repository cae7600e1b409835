"""PlaneNet with the DeepSeek-V2 trunk's forward, from a configuration's keys.

``torch._grouped_mm``, which runs the held experts' products, has no
formula in FlopCounterMode and counts 0 there; ``counted`` is what
FlopCounterMode counts.  The routed rows depend on the routing, so the
held experts' products are counted at the expected rows: T k held / E
rows a layer (each token's k choices spread evenly over the E experts),
``routed(cfg, rows)`` at any other count."""
from __future__ import annotations


def counted(cfg: dict, batch: int, points: int) -> float:
    """Per token the SIREN (3 -> d/2, d/2 -> d/2), the pool's gate and
    value; per layer and token MLA's four projections, QK^T and AV over all
    points, and the dense SwiGLU, or the router and the shared experts; per
    cloud the head."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, v, rank = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    f = cfg["moe_intermediate_size"]
    half, tokens = d // 2, batch * points
    per_token = 2 * (3 * half + half * half) + 2 * (d + d * d)
    mla = 2 * (d * h * (nope + rope) + d * (rank + rope) + rank * h * (nope + v) + h * v * d)
    mla += 2 * points * h * (nope + rope) + 2 * points * h * v
    for i in range(cfg["num_hidden_layers"]):
        per_token += mla
        if i < cfg["first_k_dense_replace"]:
            per_token += 2 * 3 * d * cfg["intermediate_size"]
        else:
            per_token += 2 * d * cfg["n_routed_experts"] + 2 * 3 * d * f * cfg["n_shared_experts"]
    return float(per_token * tokens + 2 * 3 * d * batch)


def expected_rows(cfg: dict, batch: int, points: int) -> float:
    """The held experts' rows of one MoE layer at even routing."""
    return batch * points * cfg["num_experts_per_tok"] * cfg["experts_held"] / cfg["n_routed_experts"]


def routed(cfg: dict, rows: float) -> float:
    """The held experts' products over ``rows`` rows of every MoE layer."""
    moe_layers = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    return float(moe_layers * 2 * 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"] * rows)


def forward(cfg: dict, batch: int, points: int) -> float:
    return counted(cfg, batch, points) + routed(cfg, expected_rows(cfg, batch, points))
