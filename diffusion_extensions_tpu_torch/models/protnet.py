"""Protein docking denoiser (counterpart of
``diffusion_extensions_tpu/models/protnet.py``).

(ProtBatch, t) -> AffineGrad.  Each chain's tokens are a width-3 residue
convolution, a Siren of the C-alpha positions and a Siren of the flattened
frames; a post-norm transformer encodes them (both chains in one call with a
block-diagonal mask when the encoders are shared), optional cross-attention
rounds let the chains see each other, and gated poolings feed a residual
MLP head.  Options, as in the JAX package:

* ``share_encoders`` (default, the reference's observed behaviour: the
  ligand goes through the receptor's encoder) and ``fuse_chains``;
* ``cross_depth`` rounds of bidirectional cross-attention;
* ``frame_pool`` (gated frame pooling in the readout), ``rel_frame`` (the
  bilinear P_lig P_rec^T of the pooled frames), ``equiv_head`` (predict in
  a receptor frame estimated from position moments, rotate out);
* ``bf16``: the residue convolution, the encoder and the cross layers run
  under bf16 autocast; the embeddings' Sirens, LayerNorms, poolings and the
  head stay float32.

Nothing in the forward is built from host values: the fused pass's block
mask comes from ``torch.arange`` on the batch's device, so a CUDA graph can
capture a train step.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from ..data.pdb import RES_COUNT, UNIQUE_RESIDUES
from ..ops.se3 import AffineGrad, ProtData
from .layers import (
    _TRUNC_STD,
    PoolFrame,
    PoolPos,
    PoolRN,
    Siren,
    SinusoidalPosEmb,
    TransformerCrossLayer,
    TransformerEncoder,
    dense,
    widen,
)
from .projections import ProtBatch

__all__ = ["ProtNet", "RES_COUNT", "UNIQUE_RESIDUES", "receptor_moment_frame"]

CONV_IMPLS = ("matmul", "xla_conv", "sum3")


class _Conv3(nn.Module):
    """Width-3 SAME convolution along the sequence, zero-padded:
    y[l] = W[:, :, 0] x[l-1] + W[:, :, 1] x[l] + W[:, :, 2] x[l+1] + b, on
    (B, L, Cin) -> (B, L, Cout).  ``weight`` is (Cout, Cin, 3), as
    ``nn.Conv1d`` holds it; it starts from flax ``nn.Conv``'s default init
    (LeCun truncated normal over fan-in 3 Cin, zero bias).  Computed as one
    GEMM over the three shifted copies side by side (the JAX package's
    "matmul" lowering): cuBLAS, where cuDNN's conv1d sums its weight
    gradient with atomics and gives other bits from run to run."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        std = math.sqrt(1.0 / (3 * cin)) / _TRUNC_STD
        self.weight = nn.Parameter(torch.empty(cout, cin, 3))
        self.bias = nn.Parameter(torch.zeros(cout))
        nn.init.trunc_normal_(self.weight, std=std, a=-2.0 * std, b=2.0 * std)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xp = F.pad(x, (0, 0, 1, 1))
        cols = torch.cat((xp[..., :-2, :], xp[..., 1:-1, :], xp[..., 2:, :]), dim=-1)
        w = self.weight.permute(0, 2, 1).reshape(self.weight.shape[0], -1)  # (Cout, 3 Cin)
        return F.linear(cols, w, self.bias)


class _ResConv(nn.Module):
    """Residue embedding: conv RES_COUNT -> dim, (c_depth - 2) residual
    conv + SiLU blocks, conv dim -> res_dim; float32 out under autocast.

    ``impl`` is the JAX package's choice of lowering ("matmul", "xla_conv",
    "sum3"); all three compute the same function from the same weights, and
    here all three are ``_Conv3``."""

    def __init__(self, dim: int, res_dim: int, c_depth: int, impl: str = "xla_conv"):
        super().__init__()
        if impl not in CONV_IMPLS:
            raise ValueError(f"Unexpected conv_impl: {impl}")
        if c_depth < 2:
            raise ValueError(f"c_depth must be >= 2, got {c_depth}")
        widths = [RES_COUNT] + [dim] * (c_depth - 1) + [res_dim]
        self.convs = nn.ModuleList(_Conv3(a, b) for a, b in zip(widths[:-1], widths[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, L, RES_COUNT)
        h = F.silu(self.convs[0](x))
        for conv in self.convs[1:-1]:
            h = h + F.silu(conv(h))
        return widen(self.convs[-1](h))


def receptor_moment_frame(w: torch.Tensor, positions: torch.Tensor, mask: torch.Tensor,
                          delta: float = 1e-3) -> torch.Tensor:
    """Equivariant receptor frame from position moments: ``w`` (B, L, 2)
    gates, ``positions`` (B, L, 3), ``mask`` (B, L) -> (B, 3, 3) rows of a
    right-handed frame that co-rotates with the positions and ignores a
    translation.  The first axis is the third moment of the centred,
    radius-normalised positions plus a gated mean, the second the sequence
    cross moment plus a gated mean; Gram-Schmidt is softened by ``delta``
    (a hard normalisation has 1/|v| gradients)."""
    rm = mask[..., None].to(positions.dtype)  # (B, L, 1)
    denom = torch.clamp(torch.sum(rm, dim=-2), min=1.0)  # (B, 1)
    cen = torch.sum(positions * rm, dim=-2) / denom
    d = (positions - cen[..., None, :]) * rm
    msq = torch.sum(torch.sum(d * d, dim=-1), dim=-1) / denom[..., 0]
    radius = torch.sqrt(torch.clamp(msq, min=1e-12))  # (B,)
    dn = d / radius[..., None, None]

    sq = torch.sum(dn * dn, dim=-1, keepdim=True)
    m3 = torch.sum(dn * sq, dim=-2) / denom  # third moment
    pair = rm[..., :-1, :] * rm[..., 1:, :]
    cross = torch.sum(torch.linalg.cross(dn[..., :-1, :], dn[..., 1:, :], dim=-1) * pair,
                      dim=-2) / denom  # sequence cross moment

    w = w * rm
    w_sum = torch.clamp(torch.sum(w, dim=-2), min=1e-6)  # (B, 2)
    g = torch.einsum("...lh,...ld->...hd", w, dn) / w_sum[..., None]
    v1 = m3 + g[..., 0, :]
    v2 = cross + g[..., 1, :]

    def soft_norm(v):
        return v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True) + delta**2)

    b1 = soft_norm(v1)
    b2 = soft_norm(v2 - torch.sum(b1 * v2, dim=-1, keepdim=True) * b1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack((b1, b2, b3), dim=-2)


class ProtNet(nn.Module):
    """(ProtBatch, t) -> AffineGrad (the Euler arm's raw 6-vector output
    waits for ROADMAP.md A.2)."""

    def __init__(self, dim: int = 64, heads: int = 4, t_depth: int = 4, c_depth: int = 3,
                 share_encoders: bool = True, bf16: bool = False,
                 frame_pool: bool = False, cross_depth: int = 0, rel_frame: bool = False,
                 equiv_head: bool = False, fuse_chains: bool = True, fused_qkv: bool = False,
                 conv_impl: str = "xla_conv"):
        super().__init__()
        self.bf16 = bf16
        self.share_encoders, self.fuse_chains = share_encoders, fuse_chains
        self.frame_pool, self.rel_frame, self.equiv_head = frame_pool, rel_frame, equiv_head
        pos_dim, ang_dim = dim // 2, dim // 4
        res_dim = dim - (pos_dim + ang_dim)
        self.time_embed = SinusoidalPosEmb(dim)
        self.pos_emb = Siren(3, pos_dim, scale=0.1)
        self.ang_emb = Siren(9, ang_dim)
        self.res_conv = _ResConv(dim, res_dim, c_depth, impl=conv_impl)
        self.rec_tf = TransformerEncoder(dim, heads, t_depth, final_norm=True,
                                         fused_qkv=fused_qkv)
        self.lig_tf = None if share_encoders else TransformerEncoder(
            dim, heads, t_depth, final_norm=True, fused_qkv=fused_qkv)
        # rounds of (receptor <- ligand, ligand <- receptor)
        self.cross = nn.ModuleList(TransformerCrossLayer(dim, heads)
                                   for _ in range(2 * cross_depth))
        self.r_pool, self.r_pos = PoolRN(dim), PoolPos(dim)
        self.l_pool, self.l_pos = PoolRN(dim), PoolPos(dim)
        self.moment_gate = dense(dim, 2) if equiv_head else None
        pool_frames = frame_pool or rel_frame or equiv_head
        self.r_frame = PoolFrame(dim) if pool_frames else None
        self.l_frame = PoolFrame(dim) if pool_frames else None
        head_in = 3 * dim + 6
        if equiv_head:
            head_in += 6 + 72
        if frame_pool:
            head_in += 72
        if rel_frame:
            head_in += 36
        self.head_in = dense(head_in, dim)
        self.head_hidden = nn.ModuleList(dense(dim, dim) for _ in range(3))
        self.head_out = dense(dim, 6)

    def _embed(self, prot: ProtData) -> torch.Tensor:
        """Per-chain tokens (B, L, dim); the residue conv runs along one
        chain's sequence, so chains are concatenated only after it."""
        with torch.autocast(prot.residues.device.type, dtype=torch.bfloat16,
                            enabled=self.bf16):
            res = self.res_conv(prot.residues)
        ang_flat = prot.angles.reshape(*prot.angles.shape[:-2], 9)
        return torch.cat((res, self.pos_emb(prot.positions), self.ang_emb(ang_flat)), dim=-1)

    def _encode(self, x: ProtBatch, r_feats, l_feats):
        if self.share_encoders and self.fuse_chains:
            # one encoder pass over both chains, block-diagonal attention
            lr, ll = r_feats.shape[1], l_feats.shape[1]
            feats = torch.cat((r_feats, l_feats), dim=1)
            valid = torch.cat((x.receptor_mask, x.ligand_mask), dim=1)  # (B, Lr+Ll)
            seg = torch.arange(lr + ll, device=feats.device) >= lr
            block = seg[None, :] == seg[:, None]  # (L, L)
            attn_mask = block[None, None] & valid[:, None, None, :]
            out = self.rec_tf(feats, attn_mask=attn_mask)
            return out[:, :lr], out[:, lr:]
        lig_tf = self.rec_tf if self.share_encoders else self.lig_tf
        return (self.rec_tf(r_feats, key_padding_mask=x.receptor_mask),
                lig_tf(l_feats, key_padding_mask=x.ligand_mask))

    def forward(self, x: ProtBatch, t: torch.Tensor):
        time_embed = self.time_embed(t)  # (B, dim)
        r_feats, l_feats = self._embed(x.receptor), self._embed(x.ligand)
        with torch.autocast(r_feats.device.type, dtype=torch.bfloat16, enabled=self.bf16):
            r_out, l_out = self._encode(x, r_feats, l_feats)
            # bidirectional co-attention: both updates read the pre-round tensors
            for i in range(0, len(self.cross), 2):
                r_new = self.cross[i](r_out, l_out, x.ligand_mask)
                l_new = self.cross[i + 1](l_out, r_out, x.receptor_mask)
                r_out, l_out = r_new, l_new

        rec, lig = x.receptor, x.ligand
        r_pool = self.r_pool(r_out, x.receptor_mask)
        r_pos = self.r_pos(r_out, rec.positions, x.receptor_mask)
        l_pool = self.l_pool(l_out, x.ligand_mask)
        l_pos = self.l_pos(l_out, lig.positions, x.ligand_mask)

        rhat = None
        if self.equiv_head:
            wg = torch.sigmoid(self.moment_gate(r_out))  # (B, L, 2) moment gates
            rhat = receptor_moment_frame(wg, rec.positions, x.receptor_mask)

        pieces = [time_embed, r_pool, r_pos, l_pool, l_pos]
        if rhat is not None:
            # pooled positions about the receptor centroid, in the estimated frame
            rmsk = x.receptor_mask[..., None].to(rec.positions.dtype)
            cen = torch.sum(rec.positions * rmsk, dim=-2) / torch.clamp(
                torch.sum(rmsk, dim=-2), min=1.0)
            pieces.append(torch.einsum("...ij,...j->...i", rhat, r_pos - cen))
            pieces.append(torch.einsum("...ij,...j->...i", rhat, l_pos - cen))
        if self.r_frame is not None:
            rf = self.r_frame(r_out, rec.angles, x.receptor_mask)
            lf = self.l_frame(l_out, lig.angles, x.ligand_mask)
            h = rf.shape[-1] // 9
            rm = rf.reshape(*rf.shape[:-1], h, 3, 3)
            lm = lf.reshape(*lf.shape[:-1], h, 3, 3)
            if self.frame_pool:
                pieces += [rf, lf]
            if self.rel_frame:
                rel = torch.einsum("...hij,...hkj->...hik", lm, rm)
                pieces.append(rel.reshape(*rel.shape[:-3], h * 9))
            if rhat is not None:
                rt = rhat.transpose(-1, -2)[..., None, :, :]
                lf_loc, rf_loc = torch.matmul(lm, rt), torch.matmul(rm, rt)
                pieces.append(lf_loc.reshape(*lf_loc.shape[:-3], h * 9))
                pieces.append(rf_loc.reshape(*rf_loc.shape[:-3], h * 9))
        pool = torch.cat(pieces, dim=-1)
        h = F.silu(self.head_in(pool))
        for lin in self.head_hidden:
            h = h + F.silu(lin(h))
        out = self.head_out(h)
        if rhat is not None:
            rot = torch.einsum("...ji,...j->...i", rhat, out[..., :3])
            shf = torch.einsum("...ji,...j->...i", rhat, out[..., 3:])
            out = torch.cat((rot, shf), dim=-1)
        return AffineGrad(rot_g=out[..., :3], shift_g=out[..., 3:])
