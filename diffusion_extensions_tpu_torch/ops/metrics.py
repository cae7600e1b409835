"""Rotation metrics, kernels, MMD and kernel two-sample tests (counterpart
of ``diffusion_extensions_tpu/ops/metrics.py``; the reference's
``util.py:110-151, 254-322``).

``pairwise_rotation_angle`` (four float32 matmuls of the rotation
entries), ``gaussian_kernel_matrix``, ``plain_kernel_sum`` and the MMD
estimator live in ``ops/mmd_cuda.py`` beside the kernel whose plain version
they are; this module re-exports them.

``mmd`` with ``gaussian_kernel_matrix`` on CUDA tensors sums each of its
three N x M blocks in one launch of the hand-written CUDA kernel
(``mmd_cuda.gaussian_kernel_sum``), whatever ``chunksize`` says; any other
kernel, and CPU tensors, take the chunked plain path.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from . import mmd_cuda
from .mmd_cuda import biased_mmd, gaussian_kernel_matrix, pairwise_rotation_angle, plain_kernel_sum
from .so3 import rmul

__all__ = [
    "rmat_cosine_dist",
    "rmat_cosine_kernel",
    "rmat_gaussian_kernel",
    "rmat_dist",
    "pairwise_rotation_angle",
    "gaussian_kernel_matrix",
    "cosine_kernel_matrix",
    "mmd",
    "ker_2samp_test",
    "ker_2samp_log_prob",
]


def _trace(m: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(m, dim1=-2, dim2=-1).sum(-1)


def rmat_cosine_dist(m1: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
    """1 - cos(theta) between (batched, broadcast) rotation matrices."""
    tra = _trace(rmul(m2.transpose(-1, -2), m1))
    return 1.0 - (tra - 1.0) / 2.0


def rmat_cosine_kernel(m1: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
    """cos(theta) kernel."""
    tra = _trace(rmul(m2.transpose(-1, -2), m1))
    return (tra - 1.0) / 2.0


def rmat_dist(input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Frobenius norm of log(m1^T m2) = sqrt(2) * theta, computed without
    forming the log."""
    mul = rmul(input.transpose(-1, -2), target)
    skew = mul - mul.transpose(-1, -2)
    # |skew|_F = sqrt(2) |skew2vec(skew)|, and s_angle = |skew2vec| / 2
    s = 0.5 * torch.sqrt(0.5 * torch.sum(skew * skew, dim=(-1, -2)))
    c = 0.5 * (_trace(mul) - 1.0)
    return math.sqrt(2.0) * torch.atan2(s, c)


def rmat_gaussian_kernel(m1: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
    """exp(-geodesic Frobenius distance)."""
    return torch.exp(-rmat_dist(m1, m2))


def cosine_kernel_matrix(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise ``rmat_cosine_kernel`` as an (N, M) matrix."""
    return torch.cos(pairwise_rotation_angle(x, y))


def _chunked_kernel_sum(
    x: torch.Tensor, y: torch.Tensor, kernel_matrix: Callable, chunksize: int | None
) -> torch.Tensor:
    """sum_{n,m} k(x_n, y_m): the CUDA kernel for the Gaussian kernel on the
    card (one launch; a CPU/CUDA mix raises there), else ``plain_kernel_sum``."""
    on_cpu = x.device.type == "cpu" and y.device.type == "cpu"
    if kernel_matrix is gaussian_kernel_matrix and not on_cpu:
        return mmd_cuda.gaussian_kernel_sum(x, y)
    return plain_kernel_sum(x, y, kernel_matrix, chunksize)


def mmd(
    x: torch.Tensor,
    y: torch.Tensor,
    kernel_matrix: Callable = gaussian_kernel_matrix,
    chunksize: int | None = None,
) -> torch.Tensor:
    """Biased MMD^2 estimate, as the reference's ``util.py:254-285``
    (diagonal terms included, 1/l^2 and 2/(lx*ly) weights)."""
    return biased_mmd(lambda a, b: _chunked_kernel_sum(a, b, kernel_matrix, chunksize), x, y)


def _equal_counts(x, y) -> int:
    m = x.shape[0]
    if m != y.shape[0]:
        raise ValueError(f"needs as many samples from X as from Y, got {m} and {y.shape[0]}")
    return m


def ker_2samp_test(
    x, y, kernel_matrix=gaussian_kernel_matrix, alpha=0.05, max_ker=1.0, chunksize=None
) -> bool:
    """Kernel two-sample acceptance test (reference: ``util.py:289-299``)."""
    m = _equal_counts(x, y)
    val = float(mmd(x, y, kernel_matrix, chunksize=chunksize))
    test_val = (2 * max_ker / m) ** 0.5 * (1 + (2 * math.log(1 / alpha)) ** 0.5)
    return val < test_val


def ker_2samp_log_prob(
    x, y, kernel_matrix=gaussian_kernel_matrix, max_ker=1.0, chunksize=None
) -> float:
    """Log p-value of a type-I error (reference: ``util.py:301-312``)."""
    m = _equal_counts(x, y)
    val = float(mmd(x, y, kernel_matrix, chunksize=chunksize))
    return -(((val / ((2 * max_ker / m) ** 0.5)) - 1) ** 2) / 2
