"""ProtNet, the docking denoiser, with the production options
(``frame_pool``, ``cross_depth``, ``rel_frame``, ``equiv_head``; shared
encoders, both chains in one pass).

Tokens of a chain: a width-3 zero-padded residue convolution (21 -> dim,
c_depth - 2 residual conv + SiLU blocks, dim -> res_dim), a SIREN of the
C-alpha positions (dim/2) and a SIREN of the flattened frames (dim/4).  One
post-norm transformer encodes both chains with block-diagonal attention and
a final LayerNorm; ``cross_depth`` rounds of cross-attention let each chain
read the other (both from the pre-round tensors).  The readout concatenates
the time embedding, gated means of features and positions of both chains,
with ``equiv_head`` the pooled positions in a receptor frame estimated from
position moments, gated frame means (``frame_pool``), their relative frames
(``rel_frame``) and both frame means in the receptor frame; a residual
SiLU MLP gives the (rot, shift) tangent noise, rotated out of the receptor
frame under ``equiv_head``.

A batch is a dict: ``rec_res`` / ``lig_res`` (B, L, 21) one-hot,
``rec_pos`` / ``lig_pos`` (B, L, 3), ``rec_frames`` / ``lig_frames``
(B, L, 3, 3), ``rec_mask`` / ``lig_mask`` (B, L) bool.
"""
from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from . import nn

RES_COUNT = 21
FRAME_HEADS = 4
HEAD_GAIN = 0.1


def _widths(cfg: dict) -> list:
    dim = cfg["dim"]
    res_dim = dim - dim // 2 - dim // 4
    return [RES_COUNT] + [dim] * (cfg["c_depth"] - 1) + [res_dim]


def param_spec(cfg: dict) -> list:
    dim = cfg["dim"]
    spec = nn.siren_spec("pos_emb", 3, dim // 2, 0.1) + nn.siren_spec("ang_emb", 9, dim // 4, 1.0)
    widths = _widths(cfg)
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        spec += [(f"res_conv.convs.{i}.weight", (b, a, 3), ("normal", 1.0 / math.sqrt(3 * a))),
                 (f"res_conv.convs.{i}.bias", (b,), ("normal", 0.02))]
    for i in range(cfg["t_depth"]):
        spec += nn.block_spec(f"rec_tf.layers.{i}", dim)
    spec += nn.norm_spec("rec_tf.norm", dim)
    for i in range(2 * cfg["cross_depth"]):
        spec += nn.block_spec(f"cross.{i}", dim)
    for chain in ("r", "l"):
        spec += nn.dense_spec(f"{chain}_pool.gate", dim, 1) + nn.dense_spec(f"{chain}_pool.val", dim, dim)
        spec += nn.dense_spec(f"{chain}_pos.gate", dim, 1)
    if cfg["equiv_head"]:
        spec += nn.dense_spec("moment_gate", dim, 2)
    if cfg["frame_pool"] or cfg["rel_frame"] or cfg["equiv_head"]:
        spec += nn.dense_spec("r_frame.gate", dim, FRAME_HEADS) + nn.dense_spec("l_frame.gate", dim, FRAME_HEADS)
    spec += nn.dense_spec("head_in", head_width(cfg), dim)
    for i in range(3):
        spec += nn.dense_spec(f"head_hidden.{i}", dim, dim)
    # a tenth of the fan-in scale: an untrained head's noise estimate grows
    # with the ligand's shift, and a DDIM chain that feeds it back diverges;
    # a trained one stays bounded, and so does this one
    return spec + nn.dense_spec("head_out", dim, 6, HEAD_GAIN)


def head_width(cfg: dict) -> int:
    return (3 * cfg["dim"] + 6 + (6 + 72 if cfg["equiv_head"] else 0)
            + (72 if cfg["frame_pool"] else 0) + (36 if cfg["rel_frame"] else 0))


def _conv3(p: dict, name: str, x: torch.Tensor, q=None) -> torch.Tensor:
    """y_l = W_0 x_(l-1) + W_1 x_l + W_2 x_(l+1) + b, zero beyond the ends:
    one product of the three shifted copies side by side with W (Cout,
    Cin, 3) laid out as (Cout, 3 Cin)."""
    w = p[name + ".weight"]
    xp = F.pad(x, (0, 0, 1, 1))
    cols = torch.cat((xp[:, :-2], xp[:, 1:-1], xp[:, 2:]), -1)
    return nn.matmul(cols, w.permute(0, 2, 1).reshape(w.shape[0], -1).T, q) + p[name + ".bias"]


def _tokens(p: dict, cfg: dict, res, pos, frames, q=None):
    widths = _widths(cfg)
    h = F.silu(_conv3(p, "res_conv.convs.0", res, q))
    for i in range(1, len(widths) - 2):
        h = h + F.silu(_conv3(p, f"res_conv.convs.{i}", h, q))
    h = _conv3(p, f"res_conv.convs.{len(widths) - 2}", h, q)
    return torch.cat((h, nn.siren(p, "pos_emb", pos),
                      nn.siren(p, "ang_emb", frames.reshape(*frames.shape[:-2], 9))), -1)


def moment_frame(w, pos, mask, delta: float = 1e-3):
    """(B, 3, 3) rows b1, b2, b3 of a right-handed receptor frame: b1 along
    the third moment of the centred, RMS-radius-normalised positions plus
    the first gated mean, b2 along the sequence cross moment plus the
    second, made orthogonal to b1; normalisations softened by delta."""
    m = mask[..., None].to(pos.dtype)
    n = torch.clamp(m.sum(-2), min=1.0)  # (B, 1)
    cen = (pos * m).sum(-2) / n
    d = (pos - cen[:, None]) * m
    radius = torch.sqrt(torch.clamp((d * d).sum((-1, -2)) / n[:, 0], min=1e-12))
    dn = d / radius[:, None, None]
    m3 = (dn * (dn * dn).sum(-1, keepdim=True)).sum(-2) / n
    pair = m[:, :-1] * m[:, 1:]
    cross = (torch.linalg.cross(dn[:, :-1], dn[:, 1:], dim=-1) * pair).sum(-2) / n
    w = w * m
    g = torch.einsum("blh,bld->bhd", w, dn) / torch.clamp(w.sum(-2), min=1e-6)[..., None]
    v1, v2 = m3 + g[:, 0], cross + g[:, 1]

    def unit(v):
        return v / torch.sqrt((v * v).sum(-1, keepdim=True) + delta ** 2)

    b1 = unit(v1)
    b2 = unit(v2 - (b1 * v2).sum(-1, keepdim=True) * b1)
    return torch.stack((b1, b2, torch.linalg.cross(b1, b2, dim=-1)), -2)


def forward(p: dict, cfg: dict, batch: dict, t: torch.Tensor, q=None) -> torch.Tensor:
    """-> (B, 6): rotation part, then shift part.  ``q`` rounds the
    products of the residue convolution, the encoder and the cross layers
    (the region the configuration runs in bf16)."""
    dim, heads = cfg["dim"], cfg["heads"]
    rec_mask, lig_mask = batch["rec_mask"], batch["lig_mask"]
    r = _tokens(p, cfg, batch["rec_res"], batch["rec_pos"], batch["rec_frames"], q)
    lt = _tokens(p, cfg, batch["lig_res"], batch["lig_pos"], batch["lig_frames"], q)
    lr = r.shape[1]
    h = torch.cat((r, lt), 1)
    valid = torch.cat((rec_mask, lig_mask), 1)
    seg = torch.arange(h.shape[1], device=h.device) >= lr
    mask = (seg[None, :] == seg[:, None])[None, None] & valid[:, None, None, :]
    for i in range(cfg["t_depth"]):
        h = nn.attention_block(p, f"rec_tf.layers.{i}", h, h, heads, mask, q)
    h = nn.layer_norm(p, "rec_tf.norm", h)
    r_out, l_out = h[:, :lr], h[:, lr:]
    for i in range(0, 2 * cfg["cross_depth"], 2):
        r_new = nn.attention_block(p, f"cross.{i}", r_out, l_out, heads, lig_mask[:, None, None, :], q)
        l_new = nn.attention_block(p, f"cross.{i + 1}", l_out, r_out, heads, rec_mask[:, None, None, :], q)
        r_out, l_out = r_new, l_new

    rec_pos, lig_pos = batch["rec_pos"], batch["lig_pos"]
    r_pool = nn.gated_mean(p, "r_pool", r_out, nn.linear(p, "r_pool.val", r_out), rec_mask)[:, 0]
    r_pos = nn.gated_mean(p, "r_pos", r_out, rec_pos, rec_mask)[:, 0]
    l_pool = nn.gated_mean(p, "l_pool", l_out, nn.linear(p, "l_pool.val", l_out), lig_mask)[:, 0]
    l_pos = nn.gated_mean(p, "l_pos", l_out, lig_pos, lig_mask)[:, 0]
    pieces = [nn.sinusoidal(t, dim, r_out.dtype), r_pool, r_pos, l_pool, l_pos]
    rhat = None
    if cfg["equiv_head"]:
        rhat = moment_frame(torch.sigmoid(nn.linear(p, "moment_gate", r_out)), rec_pos, rec_mask)
        m = rec_mask[..., None].to(rec_pos.dtype)
        cen = (rec_pos * m).sum(-2) / torch.clamp(m.sum(-2), min=1.0)
        pieces += [(rhat @ (r_pos - cen)[..., None])[..., 0], (rhat @ (l_pos - cen)[..., None])[..., 0]]
    if cfg["frame_pool"] or cfg["rel_frame"] or cfg["equiv_head"]:
        b = r_out.shape[0]
        rf = nn.gated_mean(p, "r_frame", r_out, batch["rec_frames"].reshape(b, lr, 9), rec_mask)
        lf = nn.gated_mean(p, "l_frame", l_out, batch["lig_frames"].reshape(b, -1, 9), lig_mask)
        rm, lm = rf.reshape(b, FRAME_HEADS, 3, 3), lf.reshape(b, FRAME_HEADS, 3, 3)
        if cfg["frame_pool"]:
            pieces += [rf.reshape(b, -1), lf.reshape(b, -1)]
        if cfg["rel_frame"]:
            pieces.append((lm @ rm.transpose(-1, -2)).reshape(b, -1))
        if rhat is not None:
            rt = rhat.transpose(-1, -2)[:, None]
            pieces += [(lm @ rt).reshape(b, -1), (rm @ rt).reshape(b, -1)]
    x = F.silu(nn.linear(p, "head_in", torch.cat(pieces, -1)))
    for i in range(3):
        x = x + F.silu(nn.linear(p, f"head_hidden.{i}", x))
    out = nn.linear(p, "head_out", x)
    if rhat is not None:
        rt = rhat.transpose(-1, -2)
        out = torch.cat(((rt @ out[:, :3, None])[..., 0], (rt @ out[:, 3:, None])[..., 0]), -1)
    return out
