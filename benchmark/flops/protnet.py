"""ProtNet's forward with shared encoders, both chains in one pass."""
from __future__ import annotations

DIM_FEEDFORWARD = 2048
RES_COUNT = 21


def forward(dim: int, t_depth: int, c_depth: int, batch: int, lr: int, ll: int, cross_depth: int = 0,
            frame_pool: bool = False, rel_frame: bool = False, equiv_head: bool = False,
            dff: int = DIM_FEEDFORWARD) -> float:
    """Per token the residue convolution (k = 3), both SIRENs, the encoder
    (q / k / v / out, the feed-forward pair, QK^T and AV over all lr + ll
    keys of the block-masked pass) and the poolings; per round the two
    cross layers; per pair the moment gate and frame, the relative frames
    and the head."""
    pos, ang = dim // 2, dim // 4
    res = dim - pos - ang
    n = lr + ll
    frames = frame_pool or rel_frame or equiv_head
    per_token = 2 * 3 * (RES_COUNT * dim + (c_depth - 2) * dim * dim + dim * res)
    per_token += 2 * (3 * pos + pos * pos) + 2 * (9 * ang + ang * ang)
    per_token += t_depth * (2 * (4 * dim * dim + 2 * dim * dff) + 4 * n * dim)
    per_token += 2 * (dim + dim * dim) + 2 * dim
    if frames:
        per_token += 2 * 4 * dim + 2 * 4 * 9
    flops = per_token * batch * n

    def cross(q, kv):
        return q * (2 * (2 * dim * dim + 2 * dim * dff) + 4 * kv * dim) + kv * 2 * 2 * dim * dim

    flops += cross_depth * batch * (cross(lr, ll) + cross(ll, lr))
    head_in = 3 * dim + 6
    per_pair = 0
    if equiv_head:
        head_in += 6 + 72
        flops += batch * lr * (2 * 2 * dim + 2 * 2 * 3)
        per_pair += 4 * 2 * 9 + 2 * 2 * 27 * 4
    if frame_pool:
        head_in += 72
    if rel_frame:
        head_in += 36
        per_pair += 2 * 27 * 4
    per_pair += 2 * (head_in * dim + 3 * dim * dim + 6 * dim)
    return float(flops + batch * per_pair)
