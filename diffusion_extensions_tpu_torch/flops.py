"""Closed-form FLOP counts of the denoisers' forward passes.

Each function counts what ``torch.utils.flop_counter.FlopCounterMode``
counts for one forward of the model at these shapes: 2 m n k for every
matrix product (``mm``, ``addmm``, ``bmm``, ``baddbmm`` and the ``bmm``
that an ``einsum`` or a batched ``matmul`` becomes), nothing for the
elementwise work, the normalisations, the softmax and the reductions.
``tests/test_torch_bench.py`` holds FlopCounterMode to these counts
exactly.  ``bench.py`` and ``chip_smoke.py`` divide them by time.
"""
from __future__ import annotations

from .data.pdb import RES_COUNT
from .models.layers import DIM_FEEDFORWARD

__all__ = ["planenet_flops", "dsv2_planenet_flops", "kda_flops", "kimi_planenet_flops", "protein_flops",
           "moe_capacity"]


def moe_capacity(tokens: int, experts: int, capacity_factor: float = 1.25) -> int:
    """The slots per expert of a single-process MoE layer over ``tokens``
    tokens: ceil(tokens * capacity_factor / E) as ``MoEFFN.capacity``
    computes it, at most the token count (``MoEFFN.width``)."""
    return min(int(-(-tokens * capacity_factor // experts)), tokens)


def planenet_flops(dim: int, layers: int, batch: int, points: int,
                   moe_experts: int = 0, dff: int = DIM_FEEDFORWARD) -> float:
    """One PlaneNet forward: per token the Siren, per layer q / k / v / out
    and the feed-forward pair plus QK^T and AV, and the pooling; per cloud
    the head.  With ``moe_experts`` E each layer's feed-forward pair runs
    over the E x C slots of the dispatch buffer (C = ``moe_capacity`` of the
    batch's tokens), padding included, and the router adds a (dim, E)
    product a token."""
    half = dim // 2
    tokens = batch * points
    per_token = 2 * (3 * half + half * half) + 2 * (dim + dim * dim)
    per_token += layers * (2 * 4 * dim * dim + 4 * points * dim)
    flops = per_token * tokens + 2 * 3 * dim * batch
    if moe_experts:
        slots = moe_experts * moe_capacity(tokens, moe_experts)
        flops += layers * (2 * 2 * dim * dff * slots + 2 * dim * moe_experts * tokens)
    else:
        flops += layers * 2 * 2 * dim * dff * tokens
    return float(flops)


def dsv2_planenet_flops(cfg, batch: int, points: int) -> float:
    """One forward of PlaneNet with the DeepSeek-V2 trunk ``cfg``
    (``models/deepseek_v2.DeepSeekV2Config``): per token the Siren and the
    pooling, per layer and token MLA's four projections plus QK^T and AV
    over all points, and the dense SwiGLU, or the router (d x E) and the
    shared experts; per cloud the head.  The held experts' products run
    through ``torch._grouped_mm``, which FlopCounterMode counts as 0; they
    are added here over the rows a MoE layer expects, T k held / E (the
    choices spread evenly over the experts)."""
    d, h = cfg.hidden_size, cfg.num_attention_heads
    nope, rope, v, rank = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    half, tokens = d // 2, batch * points
    per_token = 2 * (3 * half + half * half) + 2 * (d + d * d)
    mla = 2 * (d * h * (nope + rope) + d * (rank + rope) + rank * h * (nope + v) + h * v * d)
    mla += 2 * points * h * (nope + rope + v)
    dense = cfg.first_k_dense_replace
    moe = cfg.num_hidden_layers - dense
    per_token += cfg.num_hidden_layers * mla + dense * 2 * 3 * d * cfg.intermediate_size
    per_token += moe * (2 * d * cfg.n_routed_experts + 2 * 3 * d * cfg.moe_intermediate_size * cfg.n_shared_experts)
    rows = tokens * cfg.num_experts_per_tok * cfg.experts_held / cfg.n_routed_experts
    routed = moe * 2 * 3 * d * cfg.moe_intermediate_size * rows
    return float(per_token * tokens + 2 * 3 * d * batch + routed)


def kda_flops(points: int, heads: int, dk: int, dv: int, chunk: int) -> float:
    """The matrix products of ``models/kimi_linear.chunk_kda`` for one
    sequence of ``points`` (padded to whole chunks of C = ``chunk``), over
    all heads: per chunk the intra-chunk pairs level by level (blocks of s
    = 1, 2, ..., C/2 points: [q; k] of the upper halves against k of the
    lower, 4 s^2 dk, and the inverse's block, 4 s^3, C / 2s blocks a
    level), T V and T K, K^T W and K^T U, P W and P U, the output's Q S;
    per chunk but the last the carried state's M S."""
    nc = -(-points // chunk)
    levels, s = 0, 1
    while s < chunk:
        levels += (chunk // (2 * s)) * (4 * s * s * dk + 4 * s ** 3)
        s *= 2
    per_chunk = levels + 2 * chunk * chunk * (dk + dv) + 2 * dk * chunk * (dk + dv) \
        + 2 * chunk * chunk * (dk + dv) + 2 * chunk * dk * dv
    return float(heads * (nc * per_chunk + (nc - 1) * 2 * dk * dk * dv))


def kimi_planenet_flops(cfg, batch: int, points: int) -> float:
    """One forward of PlaneNet with the Kimi Linear trunk ``cfg``
    (``models/kimi_linear.KimiLinearConfig``): per token the Siren and the
    pooling; per KDA layer and token the q / k / v projections, the
    decay's and the output gate's low-rank pairs, beta's and W_o, and per
    cloud its chunked recurrence (``kda_flops``); per MLA layer MLA's four
    projections plus QK^T and AV over all points; the dense SwiGLU, or the
    router (d x E) and the shared expert; per cloud the head.  The held
    experts' products (``torch._grouped_mm``, counted 0 by FlopCounterMode)
    are added over the rows a MoE layer expects, T k held / E."""
    d, h = cfg.hidden_size, cfg.num_attention_heads
    nope, rope, v, rank = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    kh, dk = cfg.linear_attn_num_heads, cfg.linear_attn_head_dim
    half, tokens = d // 2, batch * points
    per_token = 2 * (3 * half + half * half) + 2 * (d + d * d)
    mla = 2 * (d * h * (nope + rope) + d * (rank + rope) + rank * h * (nope + v) + h * v * d)
    mla += 2 * points * h * (nope + rope + v)
    kda = 2 * (3 * d * kh * dk + 2 * (d * dk + dk * kh * dk) + d * kh + kh * dk * d)
    per_cloud = 0.0
    for i in range(cfg.num_hidden_layers):
        if cfg.is_kda(i):
            per_token += kda
            per_cloud += kda_flops(points, kh, dk, dk, cfg.chunk_size)
        else:
            per_token += mla
    dense = cfg.first_k_dense_replace
    moe = cfg.num_hidden_layers - dense
    per_token += dense * 2 * 3 * d * cfg.intermediate_size
    per_token += moe * (2 * d * cfg.num_experts + 2 * 3 * d * cfg.moe_intermediate_size * cfg.num_shared_experts)
    rows = tokens * cfg.num_experts_per_token * cfg.experts_held / cfg.num_experts
    routed = moe * 2 * 3 * d * cfg.moe_intermediate_size * rows
    return float(per_token * tokens + per_cloud * batch + 2 * 3 * d * batch + routed)


def protein_flops(dim: int, t_depth: int, c_depth: int, batch: int, lr: int, ll: int,
                  cross_depth: int = 0, frame_pool: bool = False, rel_frame: bool = False,
                  equiv_head: bool = False, dff: int = DIM_FEEDFORWARD) -> float:
    """One ProtNet forward with shared, fused encoders over a batch padded
    to ``lr`` receptor and ``ll`` ligand residues.  Per token: the residue
    conv (k = 3), both Sirens, the encoder (q / k / v / out, the
    feed-forward pair, QK^T and AV over all lr + ll keys of the
    block-masked pass) and the poolings (PoolRN, PoolPos, and PoolFrame's
    gate and frame sum where a frame is pooled).  Per round the two cross
    layers (queries of one chain, keys and values of the other).  Per pair
    the moment gate and frame (``equiv_head``), the relative frames and
    the head."""
    pos, ang = dim // 2, dim // 4
    res = dim - pos - ang
    n = lr + ll
    frames = frame_pool or rel_frame or equiv_head
    per_token = 2 * 3 * (RES_COUNT * dim + (c_depth - 2) * dim * dim + dim * res)
    per_token += 2 * (3 * pos + pos * pos) + 2 * (9 * ang + ang * ang)
    per_token += t_depth * (2 * (4 * dim * dim + 2 * dim * dff) + 4 * n * dim)
    per_token += 2 * (dim + dim * dim) + 2 * dim  # PoolRN, PoolPos
    if frames:
        per_token += 2 * 4 * dim + 2 * 4 * 9  # PoolFrame: 4 gates, the gated frame sums
    flops = per_token * batch * n

    def cross(q, kv):
        return (q * (2 * (2 * dim * dim + 2 * dim * dff) + 4 * kv * dim)
                + kv * 2 * 2 * dim * dim)

    flops += cross_depth * batch * (cross(lr, ll) + cross(ll, lr))
    head_in = 3 * dim + 6
    per_pair = 0
    if equiv_head:
        head_in += 6 + 72
        # the gate (dim, 2) and its moments over the receptor tokens, the two
        # pooled positions into the frame and the output out of it
        flops += batch * lr * (2 * 2 * dim + 2 * 2 * 3)
        per_pair += 4 * 2 * 9 + 2 * 2 * 27 * 4  # + both frame stacks into it
    if frame_pool:
        head_in += 72
    if rel_frame:
        head_in += 36
        per_pair += 2 * 27 * 4
    per_pair += 2 * (head_in * dim + 3 * dim * dim + 6 * dim)
    return float(flops + batch * per_pair)
