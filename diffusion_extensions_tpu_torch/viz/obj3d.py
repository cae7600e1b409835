"""Point clouds as ASCII PLY files, which MeshLab, Open3D or Blender read:
the offline stand-in for the reference's logged 3-D objects."""
from __future__ import annotations

import os

import numpy as np

__all__ = ["save_point_cloud_ply"]


def save_point_cloud_ply(path: str, points, colors=None) -> str:
    """Write an (N, 3) point cloud, with (N, 3) or (1, 3) uint8 or float
    [0, 1] ``colors``, as ASCII PLY; returns the path."""
    pts = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    col = None
    if colors is not None:
        col = np.asarray(colors)
        if col.dtype != np.uint8:
            col = (np.clip(col, 0.0, 1.0) * 255).astype(np.uint8)
        col = col.reshape(-1, 3)
        if len(col) == 1:
            col = np.repeat(col, len(pts), axis=0)
        if len(col) != len(pts):
            raise ValueError(f"{len(col)} colors for {len(pts)} points")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if col is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for i, p in enumerate(pts):
            row = f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}"
            if col is not None:
                row += f" {col[i][0]} {col[i][1]} {col[i][2]}"
            f.write(row + "\n")
    return path
