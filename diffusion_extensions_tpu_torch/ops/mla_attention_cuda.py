"""The attention core of DeepSeek-V2's multi-head latent attention (MLA):
the hand-written CUDA kernels, their plain version and the wrapper that
``models/deepseek_v2.py``'s ``MLA.forward`` calls.

Replaces no TPU kernel: the JAX package has no DeepSeek-V2 trunk.  For B
clouds of N points and H heads,

    o = softmax(scale q k^T) v,   k = [k_nope | k_pe], k_pe shared by the heads,

over every point (no mask), from the projections' outputs as they lie:

* ``q`` (B, N, H, nope + rope): ``q_proj``'s rows viewed per head;
* ``kv`` (B, N, H, nope + v): ``kv_b_proj``'s rows viewed per head,
  ``[k_nope | v]``;
* ``k_pe`` (B, N, rope): the rope slice of ``kv_a_proj_with_mqa``'s rows.

``attention(q, kv, k_pe, scale)`` returns o (B, N, H, v), which
``o_proj`` reads as (B, N, H v).  On the card it runs ``csrc/mla_attention.cu``:
the forward writes o and each row's log-sum-exp (in log2 units) and never the
(B, H, N, N) logits or probabilities; the backward (two launches: D =
rowsum(dO o) and dq, then dkv and dk_pe) recomputes the probabilities from
them, and writes dq, the gradient of ``kv`` as one (B, N, H, nope + v) tensor
and dk_pe summed over the heads in order.  The kernels take bf16 (the trunk
under ``--bf16``'s autocast) and the head dims of ``HEAD_DIMS``; the wrapper
raises on anything else.  ``attention_ref``, the chain ``MLA.forward`` ran
before (bf16 logits widened to float32, the float32 softmax, bf16 weights
under autocast), is taken only for CPU tensors, float64 included; CUDA
tensors launch the kernels or raise.

``_build.build_library`` compiles the source for sm_90a at the first call on
the card; it runs through ``ctypes`` on PyTorch's current stream.  The
counter ``ops.mla_attention.launches`` (``obs.count``) counts launches, one
a forward and two a backward (inside a captured CUDA graph once, at
capture).  ``check_operands`` (shapes, dtypes, layouts, head dims) is plain
Python that runs on the CPU too; ``launch_forward`` and ``launch_backward``
write into outputs the caller allocates.
"""
from __future__ import annotations

import ctypes

import torch

from .. import obs
from ..models.layers import widen
from ._build import CSRC, build_library

__all__ = ["attention", "attention_ref", "check_operands", "launch_forward", "launch_backward", "build",
           "HEAD_DIMS", "GATES"]

SOURCE = CSRC / "mla_attention.cu"
# (qk, rope, v) head dims the kernels are built for: DeepSeek-V2-Lite's,
# and the card tests' small trunk's
HEAD_DIMS = ((192, 64, 128), (48, 16, 32))
# each output's gate (rtol, atol) against the plain version on the card, the
# same bf16 inputs (unit normal, and dO): both round their outputs to bf16,
# the plain version its logits and its weights to bf16 before that (so it
# lies ~3x further from a float64 evaluation than the kernels, which round
# only P and dS, as tensor-core operands).  What parts them is the plain
# version's rounding: up to ~2 bf16 steps at the top of each output's range
# (|o| < 4, |dq|, |dkv| < 8, |dk_pe| < 8 at the tested shapes)
GATES = {"o": (2**-6, 2**-5), "dq": (2**-6, 2**-4), "dkv": (2**-6, 2**-4), "dk_pe": (2**-6, 2**-4)}
_MAX_GRID = 65535

build_log = ""  # nvcc's output of the last build made in this process
library_path = None  # the built shared library, once build() has run
_lib = None


def build():
    """Compile the kernels (if this source was not built before) and bind
    the forward's and the backward's launch functions."""
    global _lib, build_log, library_path
    if _lib is not None:
        return _lib
    lib, build_log, library_path = build_library(SOURCE)
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    operands = [i32, i32, i32, ptr, i64, i64, i64, ptr, i64, i64, i64, ptr, i64, i64, i32, i32, i32,
                ctypes.c_float]
    lib.mla_attention_forward.argtypes = [*operands, ptr, ptr, ptr]
    lib.mla_attention_backward.argtypes = [*operands, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr]
    for fn in (lib.mla_attention_forward, lib.mla_attention_backward):
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def attention_ref(q, kv, k_pe, scale):
    """Plain version: k = [k_nope | k_pe broadcast over the heads], the
    logits ``q k^T`` (bf16 under autocast) widened to float32 and scaled,
    their softmax in float32, the weights in v's dtype, o = weights v;
    (B, N, H, v), differentiated by autograd."""
    b, n, h, dqk = q.shape
    rope = k_pe.shape[-1]
    q, kv = q.transpose(1, 2), kv.transpose(1, 2)
    k_nope, v = kv.split([dqk - rope, kv.shape[-1] - dqk + rope], dim=-1)
    k = torch.cat((k_nope, k_pe[:, None].expand(b, h, n, rope).to(k_nope.dtype)), dim=-1)
    logits = widen(torch.matmul(q, k.transpose(-1, -2))) * scale
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(weights, v).transpose(1, 2)


# ---------------------------------------------------------------- checks

def _rows_ok(x: torch.Tensor) -> bool:
    """Unit stride in the last dim, every other stride and the start a
    multiple of 16 bytes: the kernels move rows as 16-byte vectors."""
    return (x.stride(-1) == 1 and all(s % 8 == 0 for s in x.stride()[:-1]) and x.data_ptr() % 16 == 0)


def check_operands(q, kv, k_pe) -> None:
    """Raise (TypeError, ValueError) unless ``q`` (B, N, H, qk), ``kv`` (B, N,
    H, nope + v) and ``k_pe`` (B, N, rope) are what the kernels take: bf16
    (float32 is the trunk without ``--bf16``), one device, (qk, rope, v) in
    ``HEAD_DIMS``, B and H at most 65,535, N at least 1, rows laid out for
    16-byte vectors (unit stride last, the other strides and the starts
    multiples of 8 elements)."""
    tensors = {"q": q, "kv": kv, "k_pe": k_pe}
    dtypes = {name: x.dtype for name, x in tensors.items()}
    if any(dt == torch.float32 for dt in dtypes.values()):
        raise TypeError(f"mla_attention: float32 operands {dtypes}; the kernels take bf16, the trunk "
                        f"under --bf16's autocast")
    if any(dt != torch.bfloat16 for dt in dtypes.values()):
        raise TypeError(f"mla_attention: the kernels take bf16 operands, got {dtypes}")
    if len({str(x.device) for x in tensors.values()}) != 1:
        raise ValueError(f"mla_attention: operands on {sorted({str(x.device) for x in tensors.values()})}")
    if q.dim() != 4 or kv.dim() != 4 or k_pe.dim() != 3 or kv.shape[:3] != q.shape[:3] \
            or k_pe.shape[:2] != q.shape[:2]:
        raise ValueError(f"mla_attention: q (B, N, H, qk), kv (B, N, H, nope + v) and k_pe (B, N, rope), "
                         f"got {tuple(q.shape)}, {tuple(kv.shape)} and {tuple(k_pe.shape)}")
    b, n, h, dqk = q.shape
    dims = (dqk, k_pe.shape[2], kv.shape[3] - dqk + k_pe.shape[2])
    if dims not in HEAD_DIMS:
        raise ValueError(f"mla_attention: head dims (qk, rope, v) = {dims}; the kernels are built for "
                         f"{list(HEAD_DIMS)}")
    if not (1 <= b <= _MAX_GRID and 1 <= h <= _MAX_GRID and n >= 1):
        raise ValueError(f"mla_attention: B {b} and H {h} from 1 to {_MAX_GRID}, N {n} at least 1")
    for name, x in tensors.items():
        if not _rows_ok(x):
            raise ValueError(f"mla_attention: {name} rows not laid out for 16-byte vectors: stride "
                             f"{x.stride()}, start {x.data_ptr() % 16} bytes off")


# ---------------------------------------------------------------- launches

def _call(name: str, device: torch.device, *args) -> None:
    fn = getattr(build(), name)
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError {err}")


def _operands(q, kv, k_pe, scale) -> tuple:
    b, n, h, dqk = q.shape
    rope = k_pe.shape[2]
    return (dqk, rope, kv.shape[3] - dqk + rope, q.data_ptr(), *q.stride()[:3], kv.data_ptr(),
            *kv.stride()[:3], k_pe.data_ptr(), *k_pe.stride()[:2], b, n, h, float(scale))


def launch_forward(q, kv, k_pe, scale, o, lse) -> None:
    """o (B, N, H, v) bf16 and lse (B, H, N) float32, both contiguous."""
    _call("mla_attention_forward", q.device, *_operands(q, kv, k_pe, scale), o.data_ptr(), lse.data_ptr())
    obs.count("ops.mla_attention.launches")


def launch_backward(q, kv, k_pe, scale, o, lse, grad_o, delta, dq, dkv, dk_pe) -> None:
    """From the forward's o and lse and the contiguous gradient of o: delta
    (B, H, N) float32 and dq, dkv, dk_pe (the inputs' shapes, contiguous)."""
    _call("mla_attention_backward", q.device, *_operands(q, kv, k_pe, scale), o.data_ptr(), lse.data_ptr(),
          grad_o.data_ptr(), delta.data_ptr(), dq.data_ptr(), dkv.data_ptr(), dk_pe.data_ptr())
    obs.count("ops.mla_attention.launches", 2)


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, kv, k_pe, scale):
        b, n, h, dqk = q.shape
        dv = kv.shape[3] - dqk + k_pe.shape[2]
        o = torch.empty((b, n, h, dv), dtype=q.dtype, device=q.device)
        lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
        launch_forward(q, kv, k_pe, scale, o, lse)
        ctx.save_for_backward(q, kv, k_pe, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, grad_o):
        q, kv, k_pe, o, lse = ctx.saved_tensors
        dq, dkv, dk_pe = (torch.empty(x.shape, dtype=x.dtype, device=x.device) for x in (q, kv, k_pe))
        delta = torch.empty_like(lse)
        launch_backward(q, kv, k_pe, ctx.scale, o, lse, grad_o.to(o.dtype).contiguous(), delta, dq, dkv, dk_pe)
        return dq, dkv, dk_pe, None


def attention(q, kv, k_pe, scale):
    """softmax(scale q k^T) v per head, k = [k_nope | k_pe]: (B, N, H, v);
    differentiable in ``q``, ``kv`` and ``k_pe``."""
    if q.device.type == "cpu":
        return attention_ref(q, kv, k_pe, scale)
    if q.device.type != "cuda":
        raise ValueError(f"mla_attention runs on the CPU or a CUDA device, not {q.device}")
    check_operands(q, kv, k_pe)
    return _Attention.apply(q, kv, k_pe, scale)
