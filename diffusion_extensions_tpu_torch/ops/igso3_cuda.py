"""IGSO(3) log-density + score: the hand-written CUDA kernel and its wrapper.

Replaces ``diffusion_extensions_tpu/ops/igso3_pallas.py``
(``igso3_logpdf_score_pallas``).  The kernel source is
``csrc/igso3_logpdf_score.cu``; ``_build.build_library`` compiles it with
``nvcc`` for sm_90a at first use, and it is called through ``ctypes`` on
PyTorch's current stream.

``igso3_logpdf_score(t, sigma)`` takes the plain PyTorch version
(``igso3_logpdf_score_ref``) only for tensors on the CPU.  A CUDA tensor
launches the kernel or raises.  The counter ``ops.igso3.launches``
(``obs.counter``) counts kernel launches; a launch inside a captured
CUDA graph counts once, at capture.

What the wrapper does around the launch is plain Python that runs on the
CPU too: ``plan_operands`` picks a stride (0 or 1) for ``t`` and ``sigma`` so
that a one-value operand is read in place and never expanded,
``alloc_outputs`` makes one allocation for both outputs, and
``kernel_math_ref`` is the kernel's arithmetic in plain float32 PyTorch:
``cheap_path_ref`` where the function is well-conditioned
(``cheap_domain``), the plain version's expression elsewhere (which the
kernel evaluates operation by operation).
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import obs
from ._build import CSRC, build_library

__all__ = ["igso3_logpdf_score", "igso3_logpdf_score_ref", "plan_operands", "alloc_outputs",
           "cheap_domain", "cheap_path_ref", "kernel_math_ref", "build", "GATES"]

SOURCE = CSRC / "igso3_logpdf_score.cu"
# each output's gate against the plain version (rtol, atol): those of the
# Pallas kernel's tests (tests/test_pallas.py)
GATES = {"logf": (1e-5, 1e-5), "score": (1e-4, 5e-4)}

build_log = ""  # nvcc's output of the last build made in this process
library_path = None  # the built shared library, once build() has run
_fn = None

# the kernel's cheap path runs for EXACT_BELOW <= t <= CHEAP_MAX_T and
# CHEAP_MIN_VAR <= sigma^2 <= CHEAP_MAX_VAR, except near t = pi with a small
# sigma: u = pi / sigma^2 > NEAR_PI_MIN_U and u (pi - t) < NEAR_PI_GAP
# (kExactBelow ... kNearPiGap in the source)
EXACT_BELOW = 0.02
CHEAP_MAX_T = 3.15
CHEAP_MIN_VAR, CHEAP_MAX_VAR = 1e-10, 1e20
NEAR_PI_MIN_U, NEAR_PI_GAP = 500.0, 20.0
# lowest coefficient first, the constants of the source
# (tools/fit_kernel_polys.py: sin[5], cos[6], sinh[4], cosh[5])
SIN_POLY = (1.0, -1.666666716e-01, 8.333301172e-03, -1.982934773e-04, 2.651807563e-06)
COS_POLY = (1.0, -5.000000000e-01, 4.166666791e-02, -1.388882869e-03, 2.478820716e-05,
            -2.660482323e-07)
SINH_POLY = (1.0, 1.666675955e-01, 8.329011500e-03, 2.045844012e-04)
COSH_POLY = (1.0, 4.999999404e-01, 4.166707769e-02, 1.387991477e-03, 2.563273847e-05)


def build():
    """Compile the kernel (if this source was not built before) and bind it.
    ``-fmad=false``: see the note in the source."""
    global _fn, build_log, library_path
    if _fn is not None:
        return _fn
    lib, build_log, library_path = build_library(SOURCE, ("-fmad=false",))
    fn = lib.igso3_logpdf_score_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _fn = fn
    return fn


def igso3_logpdf_score_ref(t: torch.Tensor, sigma: torch.Tensor):
    """Plain PyTorch version: (igso3_log_density, igso3_score_angle)."""
    from .igso3 import igso3_log_density, igso3_score_angle

    return igso3_log_density(t, sigma), igso3_score_angle(t, sigma)


def _horner(coefs, v: torch.Tensor) -> torch.Tensor:
    acc = torch.full_like(v, coefs[-1])
    for c in coefs[-2::-1]:
        acc = acc * v + c
    return acc


def cheap_domain(t: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Where the kernel takes its cheap path (elsewhere the exact one)."""
    from .igso3 import _rdiv

    t, sigma = torch.broadcast_tensors(t, sigma)
    var = sigma * sigma
    u = _rdiv(math.pi, var)
    near_pi = (u > NEAR_PI_MIN_U) & (math.pi * u - u * t < NEAR_PI_GAP)
    return ((t >= EXACT_BELOW) & (t <= CHEAP_MAX_T) & (var >= CHEAP_MIN_VAR)
            & (var <= CHEAP_MAX_VAR) & ~near_pi)


def kernel_math_ref(t: torch.Tensor, sigma: torch.Tensor):
    """The kernel's arithmetic in plain float32 PyTorch: ``cheap_path_ref``
    on ``cheap_domain``, the plain version elsewhere."""
    cheap = cheap_domain(t, sigma)
    logf, score = igso3_logpdf_score_ref(t, sigma)
    c_logf, c_score = cheap_path_ref(t, sigma)
    return torch.where(cheap, c_logf, logf), torch.where(cheap, c_score, score)


def cheap_path_ref(t: torch.Tensor, sigma: torch.Tensor):
    """The kernel's cheap path in plain float32 PyTorch, for
    ``cheap_domain``: the exponents x - pi u and
    -x - pi u as the plain version rounds them, two exponentials through
    exp2, polynomial sinh/cosh on [0, 1] and sin/cos of t/2, cot = cos/sin,
    one log of ratio / var^1.5, reciprocals for the other divisions.  It
    holds the kernel's formulas and constants against the plain version
    where there is no card."""
    from .igso3 import _rdiv

    t, sigma = torch.broadcast_tensors(t, sigma)
    var = sigma * sigma
    u = _rdiv(math.pi, var)
    x = u * t
    pu = math.pi * u
    small_x = x < 1.0
    log2e = math.log2(math.e)
    ea = torch.exp2(torch.where(small_x, -pu, x - pu) * log2e)
    eb = torch.exp2((-x - pu) * log2e)
    xs = torch.where(small_x, x, torch.zeros_like(x))
    x2 = xs * xs
    qs = torch.where(small_x, ea * (_horner(SINH_POLY, x2) * xs), 0.5 * (ea - eb))
    qc = torch.where(small_x, ea * _horner(COSH_POLY, x2), 0.5 * (ea + eb))
    w = 1.0 - 2.0 * qc
    a = t * w + 4.0 * math.pi * qs
    da = -2.0 * x * qs + (4.0 * math.pi * u * qc + w)
    h = 0.5 * t
    h2 = h * h
    inv_sin = 1.0 / (_horner(SIN_POLY, h2) * h)
    cs = _horner(COS_POLY, h2)
    iv = 1.0 / var
    hv = 0.5 * t * iv
    ratio = torch.clamp(0.5 * a * inv_sin, min=1e-38)
    lg = torch.log(ratio * iv * torch.rsqrt(var))
    logf = -0.5 * hv * t + (0.25 * var + (0.5 * math.log(math.pi) + lg))
    score = (da / a - hv) - 0.5 * cs * inv_sin
    return logf, score


def plan_operands(t: torch.Tensor, sigma: torch.Tensor):
    """(shape, t_arg, t_stride, sigma_arg, sigma_stride) for the kernel's C
    entry, which reads element ``i * t_stride`` of ``t_arg``'s memory and
    element ``i * sigma_stride`` of ``sigma_arg``'s for i < prod(shape).  A
    one-element operand keeps stride 0 and is passed as it is; an operand
    that already has the broadcast shape and is contiguous keeps stride 1
    and is passed as it is; only a broadcast that these two strides cannot
    express is expanded and copied."""
    if t.shape == sigma.shape or (sigma.numel() == 1 and sigma.dim() <= t.dim()):
        shape = t.shape
    elif t.numel() == 1 and t.dim() <= sigma.dim():
        shape = sigma.shape
    else:
        shape = torch.broadcast_shapes(t.shape, sigma.shape)

    def arg(a: torch.Tensor):
        if a.numel() == 1:
            return a, 0
        if a.shape == shape and a.is_contiguous():
            return a, 1
        return a.expand(shape).contiguous(), 1

    t_arg, t_stride = arg(t)
    sigma_arg, sigma_stride = arg(sigma)
    return shape, t_arg, t_stride, sigma_arg, sigma_stride


def alloc_outputs(shape, device):
    """One float32 allocation for both outputs: the two contiguous halves of
    a (2, *shape) buffer."""
    return torch.empty((2, *shape), dtype=torch.float32, device=device).unbind(0)


def igso3_logpdf_score(t: torch.Tensor, sigma: torch.Tensor):
    """Fused (log f(t; sigma), d/dt log f(t; sigma)); ``t`` and ``sigma``
    broadcast.  CPU tensors take the plain version; CUDA tensors the kernel.
    No gradient is defined (the JAX package's kernel has none either): an
    input that requires grad raises instead of coming back cut from the
    graph."""
    if torch.is_grad_enabled() and (t.requires_grad or sigma.requires_grad):
        raise RuntimeError(
            "igso3_logpdf_score defines no gradient: call it under torch.no_grad() "
            "or on detached tensors (igso3_logpdf_score_ref is differentiable)"
        )
    if t.device.type == "cpu" and sigma.device.type == "cpu":
        return igso3_logpdf_score_ref(t, sigma)
    if t.device.type != "cuda" or sigma.device != t.device:
        raise ValueError(
            f"igso3_logpdf_score: t on {t.device}, sigma on {sigma.device}; "
            "both must be on the same CUDA device (or both on the CPU)"
        )
    if t.dtype != torch.float32 or sigma.dtype != torch.float32:
        raise TypeError(
            f"igso3_logpdf_score takes float32, got {t.dtype} and {sigma.dtype}"
        )
    shape, t_arg, t_stride, sigma_arg, sigma_stride = plan_operands(t, sigma)
    logf, score = alloc_outputs(shape, t.device)
    n = logf.numel()
    if n == 0:
        return logf, score
    fn = build()
    stream = torch.cuda.current_stream(t.device).cuda_stream
    args = (t_arg.data_ptr(), t_stride, sigma_arg.data_ptr(), sigma_stride,
            logf.data_ptr(), score.data_ptr(), n, stream)
    if t.device.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(t.device):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"igso3_logpdf_score kernel launch failed: cudaError {err}")
    obs.count("ops.igso3.launches")
    return logf, score
