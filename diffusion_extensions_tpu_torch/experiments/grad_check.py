"""Tangent-projection gradient check (counterpart of
``diffusion_extensions_tpu/experiments/grad_check.py``, the reference's
``grad_test.py``):

    python -m diffusion_extensions_tpu_torch.experiments.grad_check

The identity behind projected diffusion training: a data-space gradient
field pulled back through the projection ``P(R) = data R^T`` (the VJP, here
``torch.autograd.grad``) and mapped to ``(dL/dR) R^T``, whose skew part is
a tangent (skew-vec) gradient.  The script prints how far the naive
pull-back of the analytic field is from the tangent target (its scale and
the symmetric part's share, both from the anisotropy of D^T D), then fits a
free data-space field with Adam to the tangent target under symmetry and
orthogonality penalties and requires its loss to halve.  ``--obj3d-dir``
writes the projected cloud and the fitted field's tips as PLY files.  Runs
on the card unless ``--device`` says otherwise.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import resolve_device
from ..data.shapenet import synthetic_planes
from ..ops.so3 import log_rmat, rmul, skew2vec
from ..train.optim import make_optimizer


class Problem:
    """The cloud (1, 512, 3), the rotation (pi/2 about x) and the tangent target."""

    def __init__(self, device):
        self.data = torch.from_numpy(synthetic_planes(1, points=512, seed=0)).to(device)
        self.rot = torch.tensor([[[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]]],
                                device=device)
        log_rot = log_rmat(self.rot)
        self.rot_grad = rmul(log_rot, self.rot)
        self.skew_targ = skew2vec(log_rot)  # the analytic tangent gradient
        self.proj_data = self.project(self.rot)

    def project(self, r: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.data, r.transpose(-1, -2))

    def pull_back(self, field: torch.Tensor, create_graph: bool = False) -> torch.Tensor:
        """(dL/dR) R^T for the data-space gradient ``field`` (1, N, 3): the
        VJP of the projection at R, right-multiplied by R^T."""
        r = self.rot.clone().requires_grad_(True)
        (r_grad,) = torch.autograd.grad(self.project(r), r, grad_outputs=field,
                                        create_graph=create_graph)
        return rmul(r_grad, self.rot.transpose(-1, -2))

    def naive(self) -> tuple[float, float]:
        """(scale of the analytic field's pull-back against the target, the
        symmetric part's share of its norm)."""
        s_v = self.pull_back(torch.matmul(self.data, self.rot_grad.transpose(-1, -2)))
        skew_part = 0.5 * (s_v - s_v.transpose(-1, -2))
        sym_part = 0.5 * (s_v + s_v.transpose(-1, -2))
        predict = skew2vec(skew_part)
        scale = torch.sum(predict * self.skew_targ) / torch.clamp(
            torch.sum(self.skew_targ * self.skew_targ), min=1e-12)
        return float(scale), float(torch.linalg.norm(sym_part) / torch.linalg.norm(s_v))

    def field_loss(self, field: torch.Tensor) -> torch.Tensor:
        """Tangent mismatch of the pulled-back skew part (unnormalised, as the
        reference has it), plus its symmetric part and the field's
        component along the projected cloud, squared."""
        orth_loss = torch.mean(torch.sum(self.proj_data * field, dim=-1) ** 2)
        sv = self.pull_back(field, create_graph=True)
        sv_proj = 0.5 * (sv - sv.transpose(-1, -2))
        sym_loss = torch.mean((0.5 * (sv + sv.transpose(-1, -2))) ** 2)
        return torch.mean((skew2vec(sv_proj) - self.skew_targ) ** 2) + sym_loss + orth_loss


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="Tangent-projection gradient check")
    p.add_argument("--iters", type=int, default=2000)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--obj3d-dir", dest="obj3d_dir", type=str, default=None,
                   help="write the projected cloud and the fitted field's tips as PLY "
                        "point clouds here")
    p.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    prob = Problem(device)
    scale, sym_frac = prob.naive()
    print(f"naive pullback: scale vs target {scale:.3f}, "
          f"symmetric-part fraction {sym_frac:.3f} (anisotropy of D^T D)")

    gen = torch.Generator(device=device).manual_seed(0)
    field = torch.randn(prob.data.shape, generator=gen, device=device).requires_grad_(True)
    opt = make_optimizer([("field", field)], args.lr)
    first = loss = None
    for i in range(args.iters):
        opt.zero_grad()
        loss = prob.field_loss(field)
        loss.backward()
        opt.step()
        if first is None:
            first = float(loss.detach())
        if (i + 1) % max(args.iters // 10, 1) == 0:
            print(f"iter {i + 1}: loss={float(loss.detach()):.6f}")
    last = float(loss.detach())
    # the reference is a visual experiment with no success criterion
    if not last < 0.5 * first:
        raise AssertionError(f"gradient-field optimisation did not improve: {first} -> {last}")
    print(f"grad check passed: loss {first:.4f} -> {last:.4f}")

    if args.obj3d_dir:
        from ..viz.obj3d import save_point_cloud_ply

        cloud = prob.proj_data[0].cpu().numpy()
        tips = cloud + field.detach()[0].cpu().numpy()
        save_point_cloud_ply(os.path.join(args.obj3d_dir, "projected_cloud.ply"), cloud,
                             colors=np.array([[0.2, 0.4, 1.0]]))
        save_point_cloud_ply(os.path.join(args.obj3d_dir, "grad_field_tips.ply"), tips,
                             colors=np.array([[1.0, 0.3, 0.2]]))
        print(f"obj3d: wrote projected_cloud.ply / grad_field_tips.ply under {args.obj3d_dir}")
    return {"scale": scale, "sym_frac": sym_frac, "loss_first": first, "loss_last": last,
            "iters": args.iters}


if __name__ == "__main__":
    main()
