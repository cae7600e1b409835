"""Sphere figures, drawn with matplotlib's 3-D axes under Agg.

* ``plot_rotation_frames``: the three rotated basis vectors of a batch of
  rotations, scattered on the unit sphere (the reference's Bingham and
  lock-suite figures).
* ``plot_igso3_density_spheres``: the IGSO(3) log-density of the angle to
  each axis painted on the sphere, one panel per eps (the reference's
  sphere-probabilities figure; the max over the three axes is shown).
"""
from __future__ import annotations

import numpy as np
import torch

from .colors import BLUE, GREEN, ORANGE

__all__ = ["plot_rotation_frames", "plot_igso3_density_spheres"]


def _sphere_mesh(count=101):
    phi = np.linspace(0, np.pi, count)
    theta = np.linspace(0, 2 * np.pi, count)
    phi, theta = np.meshgrid(phi, theta, indexing="ij")
    x = np.sin(phi) * np.cos(theta)
    y = np.sin(phi) * np.sin(theta)
    z = np.cos(phi)
    return x, y, z


def plot_rotation_frames(rots, out_path=None, title=None, alpha=0.6):
    """Scatter the columns (rotated x, y, z axes) of (N, 3, 3) rotations
    (numpy, or a tensor on any device) on the unit sphere."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if isinstance(rots, torch.Tensor):
        rots = rots.detach().cpu().numpy()
    rots = np.asarray(rots)
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="3d")
    sx, sy, sz = _sphere_mesh(41)
    ax.plot_wireframe(sx, sy, sz, color="lightgray", linewidth=0.3, alpha=0.4)
    for i, c in enumerate((BLUE, ORANGE, GREEN)):
        pts = rots[:, :, i]  # column i = rotated basis vector e_i
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c=c, s=6, alpha=alpha, label="xyz"[i])
    for vec, c, lbl in (((1, 0, 0), BLUE, "X"), ((0, 1, 0), ORANGE, "Y"),
                        ((0, 0, 1), GREEN, "Z")):
        ax.plot([0, vec[0]], [0, vec[1]], [0, vec[2]], c="gray", lw=0.8)
        ax.text(*(0.75 * np.asarray(vec)), lbl, color=c)
    ax.set_box_aspect((1, 1, 1))
    ax.view_init(elev=30, azim=60)
    ax.set_axis_off()
    if title:
        ax.set_title(title)
    if out_path:
        fig.savefig(out_path, dpi=150, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_igso3_density_spheres(epsilons=None, out_path=None, count=101, vmin=-7.0, vmax=15.0):
    """For each eps, paint log f(angle(point, axis)) on the sphere, the
    max over the three axes, clipped to [vmin, vmax]; the density is the
    port's float32 ``igso3_log_density`` on the CPU."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..ops.igso3 import igso3_log_density

    if epsilons is None:
        epsilons = np.logspace(-2, 0.5, 6)
    x, y, z = _sphere_mesh(count)
    points = np.stack((x, y, z), axis=0)  # (3, count, count)
    axes = np.eye(3)

    n = len(epsilons)
    fig, axlist = plt.subplots(2, (n + 1) // 2, figsize=(4 * ((n + 1) // 2), 8),
                               subplot_kw={"projection": "3d"})
    axlist = np.asarray(axlist).ravel()
    for ax3d, eps in zip(axlist, epsilons):
        log_probs = []
        for i in range(3):
            cosang = np.clip((points * axes[i][:, None, None]).sum(0), -1, 1)
            ang = torch.from_numpy(np.arccos(cosang).astype(np.float32))
            log_probs.append(igso3_log_density(ang, torch.tensor(float(eps))).numpy())
        field = np.clip(np.maximum.reduce(log_probs), vmin, vmax)
        norm = (field - vmin) / (vmax - vmin)
        ax3d.plot_surface(x, y, z, facecolors=plt.cm.jet(norm), rstride=2, cstride=2,
                          linewidth=0, antialiased=False, shade=False)
        ax3d.set_title(f"eps = {float(eps):.3g}")
        ax3d.set_box_aspect((1, 1, 1))
        ax3d.view_init(elev=30, azim=60)
        ax3d.set_axis_off()
    for ax3d in axlist[n:]:
        ax3d.set_visible(False)
    if out_path:
        fig.savefig(out_path, dpi=130, bbox_inches="tight")
        plt.close(fig)
    return fig
