"""The diffusion processes' training losses and the SE(3) DDIM step,
written from their definitions.

SO(3) (the aircraft cell): x_t = (x_0)^sqrt(acp_t) N, N ~ IGSO3(eps_t),
eps_t = sqrt(1 - acp_t); the denoiser sees the cloud rotated by x_t and
predicts log(N) / eps_t ("skewvec"); the loss is the mean squared error.
SE(3) (the protein cells): the rotation as above, the shift
sqrt(acp_t) s_0 + 75 eps_t z; the denoiser sees the ligand moved by x_t
about its centroid and predicts (log(N) / eps_t, z); the loss is the sum of
the two mean squared errors.  DDIM on SE(3) keeps the predicted unit noise
and jumps to the marginal of t_prev about the x_0 estimate.
"""
from __future__ import annotations

import torch

from . import so3

SHIFT_SCALE = 75.0


def rotate_cloud(clouds: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Every point of cloud b rotated by rot[b]: p R^T."""
    return clouds @ rot.transpose(-1, -2)


def move_ligand(lig_pos, lig_frames, lig_mask, rot, shift):
    """The ligand moved by (rot, shift) about its masked centroid c:
    positions (p - c) R^T + c + s, frames F R^T."""
    m = lig_mask[..., None].to(lig_pos.dtype)
    c = (lig_pos * m).sum(-2, keepdim=True) / torch.clamp(m.sum(-2, keepdim=True), min=1.0)
    rt = rot.transpose(-1, -2)
    pos = (lig_pos - c) @ rt + c + shift[:, None, :]
    frames = lig_frames @ rt[:, None]
    return pos, frames


def so3_loss(model, clouds, t, noise_rot, sched):
    """The aircraft loss from the identity state at timesteps ``t`` with
    rotation noise ``noise_rot``; ``model(x, t) -> (B, 3)``."""
    eps = sched.eps[t].to(noise_rot.dtype)
    x_t = noise_rot  # the identity to any power is the identity
    pred = model(rotate_cloud(clouds, x_t), t)
    target = so3.log(noise_rot) / eps[:, None]
    return ((pred - target) ** 2).mean()


def se3_loss(model, batch, t, noise_rot, z, sched):
    """The docking loss from the identity transform; ``batch`` is the
    reference's dict of protein tensors, ``model(batch, t) -> (B, 6)``
    (rotation part first)."""
    eps = sched.eps[t].to(noise_rot.dtype)[:, None]
    shift = eps * SHIFT_SCALE * z
    pos, frames = move_ligand(batch["lig_pos"], batch["lig_frames"], batch["lig_mask"],
                              noise_rot, shift)
    pred = model(dict(batch, lig_pos=pos, lig_frames=frames), t)
    rot_target = so3.log(noise_rot) / eps
    shift_target = shift / (eps * SHIFT_SCALE)
    return ((pred[:, 3:] - shift_target) ** 2).mean() + ((pred[:, :3] - rot_target) ** 2).mean()


def se3_x0(rot, shift, pred, t, sched, clip_shift, q=None):
    """The x_0 estimate of (rot, shift) at ``t`` from the unit-noise
    prediction ``pred`` (B, 6): R^(1/sqrt(acp)) exp(-c v)^T, c =
    sqrt(1/acp - 1), and the shift s / sqrt(acp) - 75 c z, clamped to
    +-clip_shift."""
    dt = rot.dtype
    c = sched.sqrt_recipm1_acp[t].to(dt)
    inv = sched.sqrt_recip_acp[t].to(dt)
    noise = so3.exp(pred[:, :3] * c[:, None], q).transpose(-1, -2)
    sh = shift * inv[:, None] - pred[:, 3:] * c[:, None] * SHIFT_SCALE
    if clip_shift > 0:
        sh = torch.clamp(sh, -clip_shift, clip_shift)
    return so3.mm(so3.power(rot, inv, q), noise, q), sh


def se3_ddim_step(rot, shift, pred, t, t_prev, sched, clip_shift, q=None):
    """One DDIM step t -> t_prev of (rot, shift) under the prediction
    ``pred``: ([R0^sqrt(acp') exp(eps' v) for both logs of R0], shift),
    (R0, s0) the x_0 estimate.  Where t_prev == t (a repeated grid point)
    the x_0 estimate is kept.  ``q`` rounds the rotation products (the
    control's TF32)."""
    dt = rot.dtype
    r0, sh0 = se3_x0(rot, shift, pred, t, sched, clip_shift, q)
    a = sched.sqrt_acp[t_prev].to(dt)
    e = sched.eps[t_prev].to(dt)
    step = so3.exp(pred[:, :3] * e[:, None], q)
    hold = (t_prev == t)[:, None, None]
    outs = [torch.where(hold, r0, so3.mm(p, step, q)) for p in so3.power_both(r0, a, q)]
    sh = torch.where(hold[:, :, 0], sh0, a[:, None] * sh0 + e[:, None] * SHIFT_SCALE * pred[:, 3:])
    return outs, sh
