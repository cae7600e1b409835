"""Gaussian rotation-kernel sum (the MMD's block sum): the hand-written CUDA
kernel, its wrapper and its plain PyTorch version.

Replaces ``diffusion_extensions_tpu/ops/mmd_pallas.py``
(``gaussian_kernel_sum_pallas``, and ``mmd_pallas`` built from three of
them).  The kernel source is ``csrc/gaussian_kernel_sum.cu``;
``_build.build_library`` compiles it with ``nvcc`` for sm_90a at first use,
and it is called through ``ctypes`` on PyTorch's current stream.

``gaussian_kernel_sum(x, y)`` takes the plain PyTorch version
(``gaussian_kernel_sum_ref``) only when both inputs are CPU tensors.  A CUDA
input launches the kernel or raises.  The counter ``ops.mmd.launches``
(``obs.counter``) counts kernel launches (one per sum: the tile pass and
its fixed-order reduction of the partials); a launch inside a captured
CUDA graph counts once, at capture.

The plain version's pairwise geodesic angle comes from bilinear forms of the
rotation entries, never from (N, M, 3, 3) relative rotations: for
M = X^T Y, trace(M) = <X, Y>_F, and the skew part's vector, of norm
2 sin(theta), is bilinear in the entries of X and Y.  So theta(n, m) =
atan2(|skew(M)| / 2, (trace(M) - 1) / 2) takes four (N, M) float32 matmuls
(TF32 is off package-wide).  ``ops/metrics.py`` builds its kernel matrices
and its MMD on these.

``kernel_terms_ref`` is the kernel's own arithmetic in plain float32
PyTorch (its K = 8 feature rows split three ways in TF32, its atan
polynomial and exp2), which the CPU tests hold against the plain version
and the JAX package.
"""
from __future__ import annotations

import ctypes
import math
from typing import Callable

import torch

from .. import obs
from ._build import CSRC, build_library

__all__ = [
    "pairwise_rotation_angle",
    "gaussian_kernel_matrix",
    "plain_kernel_sum",
    "biased_mmd",
    "gaussian_kernel_sum",
    "gaussian_kernel_sum_ref",
    "kernel_terms_ref",
    "tensor_core_features",
    "split_tf32",
    "mmd_cuda",
    "build",
    "GATES",
]

SOURCE = CSRC / "gaussian_kernel_sum.cu"
# the sum's gate against the plain version (rtol, atol): that of the Pallas
# kernel's tests (tests/test_pallas.py)
GATES = {"sum": (1e-4, 0.0)}

build_log = ""  # nvcc's output of the last build made in this process
library_path = None  # the built shared library, once build() has run
_lib = None


def build():
    """Compile the kernel (if this source was not built before) and bind it."""
    global _lib, build_log, library_path
    if _lib is not None:
        return _lib
    lib, build_log, library_path = build_library(SOURCE)
    lib.gaussian_kernel_sum_workspace.argtypes = [ctypes.c_longlong, ctypes.c_longlong]
    lib.gaussian_kernel_sum_workspace.restype = ctypes.c_longlong
    lib.gaussian_kernel_sum_tile.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    lib.gaussian_kernel_sum_tile.restype = None
    lib.gaussian_kernel_sum_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.gaussian_kernel_sum_launch.restype = ctypes.c_int
    _lib = lib
    return _lib


def tile_shape() -> tuple[int, int]:
    """(X rows, Y rows) of one tile of the built kernel."""
    lib = build()
    tile_n, tile_m = ctypes.c_int(), ctypes.c_int()
    lib.gaussian_kernel_sum_tile(ctypes.byref(tile_n), ctypes.byref(tile_m))
    return tile_n.value, tile_m.value


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


# atan(z) = z P(z^2) on [0, 1], lowest coefficient first: the constants
# kAtan0..kAtan7 of the kernel source (tools/fit_kernel_polys.py, atan[8])
ATAN_POLY = (
    9.999994636e-01, -3.333036602e-01, 1.995149702e-01, -1.392945051e-01,
    9.687653184e-02, -5.644792691e-02, 2.218549885e-02, -4.132246133e-03,
)


def tensor_core_features(r: torch.Tensor, is_x: bool) -> torch.Tensor:
    """(N, 4, 8) feature rows of (N, 3, 3) rotations, as the kernel stages
    them for its tensor-core bilinears (one k-step of K = 8 per bilinear;
    a[3 r + c] = R[r][c]):

        k-step 0, trace: X: a0 .. a7                  Y: b0 .. b7
                         (a8 b8 - 1 starts the accumulator)
        k-step 1, sx:    X: a2 a5 a8 -a1 -a4 -a7 0 0  Y: b1 b4 b7 b2 b5 b8 0 0
        k-step 2, sy:    X: a0 a3 a6 -a2 -a5 -a8 0 0  Y: b2 b5 b8 b0 b3 b6 0 0
        k-step 3, sz:    X: a1 a4 a7 -a0 -a3 -a6 0 0  Y: b0 b3 b6 b1 b4 b7 0 0
    """
    a = r.reshape(-1, 9)
    zero = torch.zeros_like(a[:, :2])
    rows = [a[:, :8]]
    for first, second in ((2, 1), (0, 2), (1, 0)):  # sx, sy, sz: X's columns
        if is_x:
            rows.append(torch.cat((r[:, :, first], -r[:, :, second], zero), dim=-1))
        else:
            rows.append(torch.cat((r[:, :, second], r[:, :, first], zero), dim=-1))
    return torch.stack(rows, dim=1)


def split_tf32(v: torch.Tensor):
    """v = hi + lo (+ ~2^-22 |v|) with both halves rounded to TF32 (10
    mantissa bits, to nearest with ties away from zero, as cvt.rna.tf32)."""
    def tf32(a):
        bits = a.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    hi = tf32(v)
    return hi, tf32(v - hi)


def kernel_terms_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The (N, M) terms exp(-sqrt(2) theta) as the CUDA kernel evaluates
    them, in plain float32 PyTorch: the unscaled atan2 arguments
    s = |skew(X^T Y)| and c = tr(X^T Y) - 1, from ``tensor_core_features``
    split three ways (hi hi + hi lo + lo hi); the octant reduction
    z = min(s, |c|) / max(s, |c|), the ``ATAN_POLY`` polynomial, theta = pi/2 - copysign(s > |c| ? p : pi/2 - p, c), and one
    exp2 with sqrt(2) log2(e) folded in.  It holds the kernel's formulas
    against ``gaussian_kernel_matrix`` where there is no card."""
    fx, fy = tensor_core_features(x, True), tensor_core_features(y, False)
    (xh, xl), (yh, yl) = split_tf32(fx), split_tf32(fy)
    bil = (torch.einsum("nsk,msk->snm", xh, yl) + torch.einsum("nsk,msk->snm", xl, yh)
           + torch.einsum("nsk,msk->snm", xh, yh))
    c = bil[0] + (x[:, 2, 2, None] * y[None, :, 2, 2] - 1.0)
    sx, sy, sz = bil[1], bil[2], bil[3]
    s = torch.sqrt(sx * sx + sy * sy + sz * sz + 1e-36)
    ac = c.abs()
    z = torch.minimum(s, ac) / torch.maximum(s, ac)
    z2 = z * z
    p = torch.full_like(z, ATAN_POLY[-1])
    for coef in ATAN_POLY[-2::-1]:
        p = p * z2 + coef
    p = p * z
    u = torch.where(s > ac, p, 0.5 * math.pi - p)
    scale = math.sqrt(2.0) * math.log2(math.e)
    return torch.exp2(torch.copysign(u, c) * scale - scale * 0.5 * math.pi)


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
    CUDA inputs the kernel.  No gradient is defined (the JAX package's
    kernel has none either): an input that requires grad raises instead of
    coming back cut from the graph."""
    if torch.is_grad_enabled() and (x.requires_grad or y.requires_grad):
        raise RuntimeError(
            "gaussian_kernel_sum defines no gradient: call it under torch.no_grad() "
            "or on detached tensors (gaussian_kernel_sum_ref is differentiable)"
        )
    if x.device.type == "cpu" and y.device.type == "cpu":
        return gaussian_kernel_sum_ref(x, y)
    _check(x, y)  # before any build
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
    obs.count("ops.mmd.launches")
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
