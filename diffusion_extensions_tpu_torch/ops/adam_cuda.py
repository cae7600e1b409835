"""Adam's update of every leaf: the hand-written CUDA kernel, its plain
version and the wrapper that ``train/optim.py``'s ``Adam.step`` calls.

Replaces no TPU kernel: the JAX package's Adam is optax's chain or its
``fused_adam``, both left to XLA's fusion.  The kernel source is
``csrc/adam_update.cu``; ``_build.build_library`` compiles it with ``nvcc``
for sm_90a at first use, and it is called through ``ctypes`` on PyTorch's
current stream.  One launch updates every leaf (up to ``MAX_LEAVES`` leaves;
more take one launch each ``MAX_LEAVES``), reading each element once and
writing it once.

``adam_update`` takes the plain PyTorch version (``adam_update_ref``) only
for tensors on the CPU.  CUDA tensors launch the kernel or raise.  The
counter ``ops.adam.launches`` (``obs.counter``) counts kernel launches; a
launch inside a captured CUDA graph counts once, at capture.

The two orders of the arithmetic (``impl``): ``"optax"``, the plain chain,
rounds as ``optax.chain(clip_by_global_norm(clip), adam(lr))`` does, one
PyTorch operation at a time; ``"fused"``, the JAX package's ``fused_adam``,
rounds as one ``torch._foreach_*`` sweep over all leaves.  The kernel rounds
each operation as its plain version does, in that version's order.

What the wrapper does around the launch is plain Python that runs on the
CPU too: ``plan_chunks`` cuts the leaves into the launches' chunks, and
``chunk_cover`` is the kernel's own mapping from a chunk to its elements.
"""
from __future__ import annotations

import bisect
import ctypes

import torch

from .. import obs
from ._build import CSRC, build_library

__all__ = ["adam_update", "adam_update_ref", "plan_chunks", "chunk_cover", "build",
           "CHUNK", "MAX_LEAVES", "GATES"]

SOURCE = CSRC / "adam_update.cu"
CHUNK = 8192  # elements a block updates: a multiple of 4 (the 16-byte vectors)
MAX_LEAVES = 640  # kMaxLeaves in the source: the leaf table fits a launch's 32,764 bytes
# each output's gate against the plain version: None, its bits
GATES = {"weights": None, "mu": None, "nu": None}

build_log = ""  # nvcc's output of the last build made in this process
library_path = None  # the built shared library, once build() has run
_fn = None


def build():
    """Compile the kernel (if this source was not built before) and bind it.
    ``-fmad=false``: every fused multiply-add of the kernel is written out,
    every other product and sum rounds on its own, as in the plain version."""
    global _fn, build_log, library_path
    if _fn is not None:
        return _fn
    lib, build_log, library_path = build_library(SOURCE, ("-fmad=false",))
    fn = lib.adam_update_launch
    table = ctypes.POINTER(ctypes.c_longlong)
    fn.argtypes = [ctypes.c_int, table, table, table, table, table, table,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
                   ctypes.c_float, ctypes.c_float, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _fn = fn
    return fn


def _chain_ref(params, grads, mu, nu, lr_t, bc1, bc2, norm, b1, b2, eps, clip) -> None:
    if norm is not None:
        under = norm < clip
        grads = [torch.where(under, g, (g / norm) * clip) for g in grads]
    for p, g, m, v in zip(params, grads, mu, nu):
        m.copy_((1.0 - b1) * g + b1 * m)
        v.copy_((1.0 - b2) * (g * g) + b2 * v)
        update = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        p.add_(update * -lr_t)


def _fused_ref(params, grads, mu, nu, lr_t, bc1, bc2, scale, b1, b2, eps) -> None:
    if scale is not None:
        grads = torch._foreach_mul(grads, scale)
    compressed = any(m.dtype != torch.float32 for m in mu)
    mu32 = [m.float() for m in mu] if compressed else mu
    nu32 = [v.float() for v in nu] if compressed else nu
    torch._foreach_mul_(mu32, b1)
    torch._foreach_add_(mu32, grads, alpha=1.0 - b1)
    torch._foreach_mul_(nu32, b2)
    torch._foreach_addcmul_(nu32, grads, grads, value=1.0 - b2)
    update = torch._foreach_div(mu32, bc1)
    torch._foreach_mul_(update, -lr_t)
    denom = torch._foreach_div(nu32, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    torch._foreach_div_(update, denom)
    torch._foreach_add_(params, update)
    if compressed:
        torch._foreach_copy_(mu, mu32)
        torch._foreach_copy_(nu, nu32)


def adam_update_ref(params, grads, mu, nu, lr_t, bc1, bc2, clip_value, *, impl: str,
                    b1: float, b2: float, eps: float, clip: float) -> None:
    """Plain PyTorch version: one Adam update of ``params`` (in place) and of
    the moments ``mu``, ``nu`` (in place, float32 or bf16) from ``grads``.
    ``lr_t`` is the learning rate, ``bc1`` / ``bc2`` the bias corrections
    1 - b^count (tensors).  ``clip_value`` is ``None`` without a clip, else
    the gradients' global norm (``impl="optax"``: a gradient is left alone
    under ``clip`` and scaled by ``clip / norm`` otherwise) or the scale
    ``min(1, clip / max(norm, 1e-12))`` folded into the gradients
    (``impl="fused"``).  The fused order casts bf16 moments up to float32
    before the update and down after it."""
    if impl == "fused":
        _fused_ref(params, grads, mu, nu, lr_t, bc1, bc2, clip_value, b1, b2, eps)
    else:
        _chain_ref(params, grads, mu, nu, lr_t, bc1, bc2, clip_value, b1, b2, eps, clip)


def plan_chunks(sizes: list[int]) -> list[tuple[list[int], list[int]]]:
    """The launches for leaves of ``sizes`` elements: each one
    ``(leaves, first_chunk)``, the indices of at most ``MAX_LEAVES`` leaves
    and the first of each leaf's chunks of ``CHUNK`` elements, followed by
    the launch's number of chunks (one block a chunk).  An empty leaf is in
    no launch."""
    launches, leaves, first = [], [], [0]
    for i, n in enumerate(sizes):
        if n == 0:
            continue
        if len(leaves) == MAX_LEAVES:
            launches.append((leaves, first))
            leaves, first = [], [0]
        leaves.append(i)
        first.append(first[-1] + -(-n // CHUNK))
    if leaves:
        launches.append((leaves, first))
    return launches


def chunk_cover(sizes: list[int], first_chunk: list[int]) -> list[tuple[int, int, int]]:
    """``(leaf, start, stop)`` of each chunk of a launch over leaves of
    ``sizes``, chunk by chunk, as the kernel's blocks find them: the leaf is
    the last one whose first chunk is at or before the block's."""
    out = []
    for c in range(first_chunk[-1]):
        leaf = bisect.bisect_right(first_chunk, c, hi=len(sizes)) - 1
        start = (c - first_chunk[leaf]) * CHUNK
        out.append((leaf, start, min(start + CHUNK, sizes[leaf])))
    return out


def _dense(t: torch.Tensor) -> bool:
    """Whether ``t``'s elements fill its memory span once, in some order of
    its dimensions (the kernel reads it as a flat array)."""
    expected = 1
    for stride, size in sorted((s, n) for s, n in zip(t.stride(), t.shape) if n != 1):
        if stride != expected:
            return False
        expected *= size
    return True


def _leaf(name: int, quad, index: int, dtensor: type) -> tuple:
    """The local tensors (shards of a ``dtensor``) of leaf ``name``'s
    parameter, gradient and moments, checked for the kernel on the CUDA
    device ``index``."""
    p, g, m, v = [t.to_local() if isinstance(t, dtensor) else t for t in quad]
    if not p.get_device() == g.get_device() == m.get_device() == v.get_device() == index:
        raise ValueError(f"adam_update: leaf {name} has tensors on "
                         f"{[str(t.device) for t in (p, g, m, v)]}, the update runs on "
                         f"cuda:{index}")
    if p.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError(f"adam_update: leaf {name}: parameter {p.dtype} and gradient "
                        f"{g.dtype}; both must be float32")
    if m.dtype != v.dtype or m.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"adam_update: leaf {name}: moments {m.dtype} and {v.dtype}; both "
                        "must be float32 or both bfloat16")
    shape, stride = p.shape, p.stride()
    if not (g.shape == m.shape == v.shape == shape and g.stride() == m.stride() == v.stride()
            == stride and (p.is_contiguous() or not p.numel() or _dense(p))):
        raise ValueError(f"adam_update: leaf {name}: parameter, gradient and moments must "
                         "share one dense layout (shapes "
                         f"{[tuple(t.shape) for t in (p, g, m, v)]}, strides "
                         f"{[t.stride() for t in (p, g, m, v)]})")
    return p, g, m, v


def adam_update(params, grads, mu, nu, lr_t, bc1, bc2, clip_value, *, impl: str,
                b1: float, b2: float, eps: float, clip: float) -> None:
    """One Adam update of every leaf, in place; the arguments are
    ``adam_update_ref``'s.  CPU tensors take the plain version; CUDA tensors
    the kernel, which rounds as the plain version does on the card.  A
    DTensor is updated through its local shard."""
    kw = dict(impl=impl, b1=b1, b2=b2, eps=eps, clip=clip)
    if lr_t.device.type == "cpu":
        return adam_update_ref(params, grads, mu, nu, lr_t, bc1, bc2, clip_value, **kw)
    if lr_t.device.type != "cuda":
        raise ValueError(f"adam_update runs on the CPU or a CUDA device, not {lr_t.device}")
    if impl not in ("optax", "fused"):
        raise ValueError(f"unknown optimizer impl: {impl!r}")
    from torch.distributed.tensor import DTensor

    device = lr_t.device
    if isinstance(clip_value, DTensor):
        clip_value = clip_value.full_tensor()  # the norm over every shard
    scalars = [lr_t, bc1, bc2] + ([] if clip_value is None else [clip_value])
    for t in scalars:
        if t.device != device or t.dtype != torch.float32 or t.numel() != 1:
            got = [(tuple(t.shape), t.dtype, t.device) for t in scalars]
            raise ValueError(f"adam_update: the step's scalars must be one float32 each on "
                             f"{device}, got {got}")
    if not len(params) == len(grads) == len(mu) == len(nu):
        raise ValueError("adam_update: params, grads, mu and nu must be lists of one length")
    leaves = [_leaf(i, quad, device.index, DTensor)
              for i, quad in enumerate(zip(params, grads, mu, nu))]
    if len({m.dtype for _, _, m, _ in leaves}) > 1:
        raise TypeError("adam_update: every leaf's moments must have one dtype")
    sizes = [p.numel() for p, _, _, _ in leaves]
    launches = plan_chunks(sizes)
    if not launches:
        return
    bf16 = int(leaves[0][2].dtype == torch.bfloat16)
    if bf16 and impl != "fused":
        raise ValueError("adam_update: bf16 moments take the fused order "
                         "(make_optimizer refuses them with optax)")
    fn = build()
    stream = torch.cuda.current_stream(device).cuda_stream
    clip_ptr = None if clip_value is None else clip_value.data_ptr()
    consts = [ctypes.c_float(x) for x in (b1, 1.0 - b1, b2, 1.0 - b2, eps, clip)]

    def table(values):
        return (ctypes.c_longlong * len(values))(*values)

    for which, first in launches:
        cols = [table([leaves[i][k].data_ptr() for i in which]) for k in range(4)]
        args = (len(which), table(first), table([sizes[i] for i in which]), *cols,
                lr_t.data_ptr(), bc1.data_ptr(), bc2.data_ptr(), clip_ptr, *consts, CHUNK,
                int(impl == "fused"), bf16, stream)
        if device.index == torch.cuda.current_device():
            err = fn(*args)
        else:
            with torch.cuda.device(device):
                err = fn(*args)
        if err != 0:
            raise RuntimeError(f"adam_update kernel launch failed: cudaError {err}")
        obs.count("ops.adam.launches")
