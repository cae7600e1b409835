"""Gaussian rotation-kernel sum (the MMD's block sum): the hand-written CUDA
kernel, its wrapper and its plain PyTorch version.

Replaces ``diffusion_extensions_tpu/ops/mmd_pallas.py``
(``gaussian_kernel_sum_pallas``, and ``mmd_pallas`` built from three of
them).  The kernel source is ``csrc/gaussian_kernel_sum.cu``;
``_build.build_library`` compiles it with ``nvcc`` for sm_90a at first use,
and it is called through ``ctypes`` on PyTorch's current stream.

``gaussian_kernel_sum(x, y)`` takes the plain PyTorch version
(``gaussian_kernel_sum_ref``) only when both inputs are CPU tensors.  A CUDA
input launches the kernel or raises.  ``launches`` counts kernel launches
(one per sum: the tile pass and its fixed-order reduction of the partials).

The plain version's pairwise geodesic angle comes from bilinear forms of the
rotation entries, never from (N, M, 3, 3) relative rotations: for
M = X^T Y, trace(M) = <X, Y>_F, and the skew part's vector, of norm
2 sin(theta), is bilinear in the entries of X and Y.  So theta(n, m) =
atan2(|skew(M)| / 2, (trace(M) - 1) / 2) takes four (N, M) float32 matmuls
(TF32 is off package-wide).  ``ops/metrics.py`` builds its kernel matrices
and its MMD on these.
"""
from __future__ import annotations

import ctypes
import math
from typing import Callable

import torch

from ._build import CSRC, build_library

__all__ = [
    "pairwise_rotation_angle",
    "gaussian_kernel_matrix",
    "plain_kernel_sum",
    "biased_mmd",
    "gaussian_kernel_sum",
    "gaussian_kernel_sum_ref",
    "mmd_cuda",
    "build",
]

SOURCE = CSRC / "gaussian_kernel_sum.cu"

launches = 0  # kernel launches since import (or the caller's last reset)
build_log = ""  # nvcc's output of the last build made in this process
_lib = None


def build():
    """Compile the kernel (if this source was not built before) and bind it."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    lib, build_log = build_library(SOURCE)
    lib.gaussian_kernel_sum_workspace.argtypes = [ctypes.c_longlong, ctypes.c_longlong]
    lib.gaussian_kernel_sum_workspace.restype = ctypes.c_longlong
    lib.gaussian_kernel_sum_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.gaussian_kernel_sum_launch.restype = ctypes.c_int
    _lib = lib
    return lib


def pairwise_rotation_angle(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(N, M) geodesic angles theta(X_n, Y_m) of (N, 3, 3) and (M, 3, 3)
    rotations, from four matmuls:

        trace(X^T Y)              = <X, Y>_F  -> Xf @ Yf^T
        (X^T Y)_ab - (X^T Y)_ba   = <X_:b, Y_:a> - <X_:a, Y_:b>
                                  -> [X_:b, -X_:a] @ [Y_:a, Y_:b]^T
    """
    xf = x.reshape(*x.shape[:-2], 9)
    yf = y.reshape(*y.shape[:-2], 9)
    tra = torch.matmul(xf, yf.T)

    def skew_comp(a: int, b: int) -> torch.Tensor:
        # g[b, a] - g[a, b] with g = X^T Y (columns X_:i are x[..., :, i])
        u = torch.cat((x[..., :, b], -x[..., :, a]), dim=-1)  # (N, 6)
        v = torch.cat((y[..., :, a], y[..., :, b]), dim=-1)  # (M, 6)
        return torch.matmul(u, v.T)

    sx = skew_comp(1, 2)  # g21 - g12
    sy = skew_comp(2, 0)  # g02 - g20
    sz = skew_comp(0, 1)  # g10 - g01
    s_angle = 0.5 * torch.sqrt(sx * sx + sy * sy + sz * sz)
    c_angle = 0.5 * (tra - 1.0)
    return torch.atan2(s_angle, c_angle)


def gaussian_kernel_matrix(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise ``rmat_gaussian_kernel`` as an (N, M) matrix."""
    return torch.exp(-math.sqrt(2.0) * pairwise_rotation_angle(x, y))


def plain_kernel_sum(
    x: torch.Tensor, y: torch.Tensor, kernel_matrix: Callable, chunksize: int | None
) -> torch.Tensor:
    """sum_{n,m} k(x_n, y_m) in plain PyTorch with O(chunk^2) memory: the
    chunk sums are added in float32, row-block by row-block."""
    n, m = x.shape[0], y.shape[0]
    if chunksize is None or chunksize >= max(n, m):
        return torch.sum(kernel_matrix(x, y))
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, n, chunksize):
        for j in range(0, m, chunksize):
            total = total + torch.sum(kernel_matrix(x[i : i + chunksize], y[j : j + chunksize]))
    return total


def gaussian_kernel_sum_ref(x: torch.Tensor, y: torch.Tensor, chunksize: int | None = None):
    """Plain PyTorch version: sum(gaussian_kernel_matrix(x, y)), chunked."""
    return plain_kernel_sum(x, y, gaussian_kernel_matrix, chunksize)


def _check(x: torch.Tensor, y: torch.Tensor) -> None:
    if x.device.type != "cuda" or y.device != x.device:
        raise ValueError(
            f"gaussian_kernel_sum: x on {x.device}, y on {y.device}; "
            "both must be on the same CUDA device (or both on the CPU)"
        )
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"gaussian_kernel_sum takes float32, got {x.dtype} and {y.dtype}")
    for name, r in (("x", x), ("y", y)):
        if r.dim() != 3 or r.shape[1:] != (3, 3) or r.shape[0] == 0:
            raise ValueError(f"gaussian_kernel_sum: {name} must be (N >= 1, 3, 3), got {tuple(r.shape)}")


def gaussian_kernel_sum(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sum_{n,m} exp(-sqrt(2) theta(X_n, Y_m)) for (N, 3, 3) and (M, 3, 3)
    rotations: a float32 scalar tensor.  CPU inputs take the plain version;
    CUDA inputs the kernel."""
    global launches
    if x.device.type == "cpu" and y.device.type == "cpu":
        return gaussian_kernel_sum_ref(x, y)
    _check(x, y)
    lib = build()
    n, m = x.shape[0], y.shape[0]
    xf = x.reshape(n, 9).contiguous()
    yf = y.reshape(m, 9).contiguous()
    partials = torch.empty(lib.gaussian_kernel_sum_workspace(n, m), dtype=torch.float32,
                           device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.gaussian_kernel_sum_launch(xf.data_ptr(), n, yf.data_ptr(), m,
                                             partials.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"gaussian_kernel_sum kernel launch failed: cudaError {err}")
    launches += 1
    return out


def biased_mmd(kernel_sum: Callable, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Biased MMD^2 from ``kernel_sum(a, b) = sum_{n,m} k(a_n, b_m)``, as the
    reference's ``util.py:254-285`` (diagonal terms included, 1/l^2 and
    2/(lx*ly) weights)."""
    l_x, l_y = x.shape[0], y.shape[0]
    x_sum = kernel_sum(x, x)
    y_sum = kernel_sum(y, y)
    xy_sum = kernel_sum(x, y)
    return x_sum / l_x**2 + y_sum / l_y**2 - 2.0 * xy_sum / (l_x * l_y)


def mmd_cuda(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Biased MMD^2 with the Gaussian rotation kernel from three kernel sums
    (``metrics.mmd`` with ``gaussian_kernel_matrix``)."""
    return biased_mmd(gaussian_kernel_sum, x, y)
