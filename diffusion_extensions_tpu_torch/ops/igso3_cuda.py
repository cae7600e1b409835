"""IGSO(3) log-density + score: the hand-written CUDA kernel and its wrapper.

Replaces ``diffusion_extensions_tpu/ops/igso3_pallas.py``
(``igso3_logpdf_score_pallas``).  The kernel source is
``csrc/igso3_logpdf_score.cu``; ``_build.build_library`` compiles it with
``nvcc`` for sm_90a at first use, and it is called through ``ctypes`` on
PyTorch's current stream.

``igso3_logpdf_score(t, sigma)`` takes the plain PyTorch version
(``igso3_logpdf_score_ref``) only for tensors on the CPU.  A CUDA tensor
launches the kernel or raises.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import CSRC, build_library

__all__ = ["igso3_logpdf_score", "igso3_logpdf_score_ref", "build"]

SOURCE = CSRC / "igso3_logpdf_score.cu"

launches = 0  # kernel launches since import (or the caller's last reset)
build_log = ""  # nvcc's output of the last build made in this process
_fn = None


def build():
    """Compile the kernel (if this source was not built before) and bind it.
    ``-fmad=false``: see the note in the source."""
    global _fn, build_log
    if _fn is not None:
        return _fn
    lib, build_log = build_library(SOURCE, ("-fmad=false",))
    fn = lib.igso3_logpdf_score_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _fn = fn
    return fn


def igso3_logpdf_score_ref(t: torch.Tensor, sigma: torch.Tensor):
    """Plain PyTorch version: (igso3_log_density, igso3_score_angle)."""
    from .igso3 import igso3_log_density, igso3_score_angle

    return igso3_log_density(t, sigma), igso3_score_angle(t, sigma)


def igso3_logpdf_score(t: torch.Tensor, sigma: torch.Tensor):
    """Fused (log f(t; sigma), d/dt log f(t; sigma)); ``t`` and ``sigma``
    broadcast.  CPU tensors take the plain version; CUDA tensors the kernel."""
    global launches
    t, sigma = torch.broadcast_tensors(t, sigma)
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
    t = t.contiguous()
    sigma = sigma.contiguous()
    logf = torch.empty_like(t)
    score = torch.empty_like(t)
    if t.numel() == 0:
        return logf, score
    fn = build()
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        err = fn(t.data_ptr(), sigma.data_ptr(), logf.data_ptr(),
                 score.data_ptr(), t.numel(), stream)
    if err != 0:
        raise RuntimeError(f"igso3_logpdf_score kernel launch failed: cudaError {err}")
    launches += 1
    return logf, score
