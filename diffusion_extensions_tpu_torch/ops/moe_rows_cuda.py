"""The DeepSeek-V2 experts layer's row passes over the held rows: the
hand-written CUDA kernels, their plain versions and the wrappers that
``models/deepseek_v2.py``'s ``DeepSeekMoE._held_experts`` calls.

Replaces no TPU kernel: the JAX package has no DeepSeek-V2 trunk.  The layer
sorts its T k choices by held expert (``dispatch_plan``): ``order`` lists
the choices row by row, ``inv`` gives each choice's row, and the first ``n =
offs[-1]`` rows are the held experts' (``offs`` the groups' ends, on the
device).  The static (T k, .) buffers keep the step replayable in a CUDA
graph; the kernels read n on the card and touch only rows ``[0, n)``:

* ``gather(tokens, order, inv, offs, dtype)``: row r < n is token ``order[r]
  // k`` rounded to ``dtype``; its backward sums each token's held rows in
  the choices' order, in float32.
* ``swiglu(h1, offs)``: ``silu(gate) * up`` of the first grouped product's
  ``[gate | up]`` rows; its backward recomputes ``silu(gate)``.
* ``combine(ys, w, inv, offs)``: ``out[t] = sum_j [held] w[t, j] ys[inv[t k
  + j]]`` in float32; its backward writes each held row's gradient once (no
  zero fill, no atomics) and ``w``'s gradient, 0 for a choice not held.

Each takes the plain version (``gather_ref``, ``swiglu_ref``,
``combine_ref``: the layer's PyTorch chain, differentiated by autograd) only
for tensors on the CPU; CUDA tensors launch the kernels or raise.  The
kernel source is ``csrc/moe_rows.cu``; ``_build.build_library`` compiles it
for sm_90a at the first call on the card, and it runs through ``ctypes`` on
PyTorch's current stream.  The counter ``ops.moe_rows.launches``
(``obs.counter``) counts launches (inside a captured CUDA graph once, at
capture).  The kernels round as the plain versions do on the card, except
the combine's gradient of ``w``, a float32 dot product summed in another
order.

What surrounds the launches is plain Python that runs on the CPU too:
``check_operands`` (shapes, dtypes, layouts), ``row_sources`` and
``token_rows`` (the kernels' index maps), ``launch_*`` (one kernel each,
into outputs the caller allocates).
"""
from __future__ import annotations

import ctypes

import torch
from torch.nn import functional as F

from .. import obs
from ._build import CSRC, build_library

__all__ = ["gather", "swiglu", "combine", "gather_ref", "swiglu_ref", "combine_ref", "dispatch_plan",
           "row_sources", "token_rows", "check_operands", "grad_w_atol", "build", "MAX_K", "ROW_DTYPES",
           "GATES"]

SOURCE = CSRC / "moe_rows.cu"
MAX_K = 8  # kMaxK in the source: a token's choices the kernels hold in registers
ROW_DTYPES = (torch.bfloat16, torch.float32)
# each output's gate against the plain version: None, its bits (the rows
# under n and the per-token results); the combine's gradient of the weights
# within grad_w_atol (rtol 0)
GATES = {"rows": None}
_INT32_MAX = 2**31 - 1

build_log = ""  # nvcc's output of the last build made in this process
library_path = None  # the built shared library, once build() has run
_lib = None


def build():
    """Compile the kernels (if this source was not built before) and bind
    their six launch functions."""
    global _lib, build_log, library_path
    if _lib is not None:
        return _lib
    lib, build_log, library_path = build_library(SOURCE)
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    signatures = {
        "moe_gather_launch": [i32, ptr, i64, ptr, i32, ptr, ptr, i64, i64, i32, ptr],
        "moe_gather_backward_launch": [i32, ptr, i64, ptr, i32, ptr, i32, ptr, i64, i32, ptr],
        "moe_swiglu_launch": [i32, ptr, i64, ptr, i32, ptr, i64, i64, ptr],
        "moe_swiglu_backward_launch": [i32, ptr, i64, ptr, i64, ptr, i32, ptr, i64, i64, ptr],
        "moe_combine_launch": [i32, ptr, i64, ptr, ptr, i32, ptr, i32, ptr, i64, i32, ptr],
        "moe_combine_backward_launch": [i32, ptr, i64, ptr, i64, ptr, ptr, i32, ptr, i32, ptr, i64,
                                        ptr, i32, ptr],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    _lib = lib
    return lib


def dispatch_plan(top_i: torch.Tensor, first_expert: int, held: int):
    """The sort of the T k choices ``top_i`` (T, k) by held expert (experts
    ``first_expert`` .. ``first_expert + held - 1``; the others last, in
    their order): ``order`` (T k,) the choice of each row, ``inv`` (T k,)
    the row of each choice, ``counts`` (held,) each held expert's rows and
    ``offs`` (held,) int32 their ends.  Static shapes, nothing read on the
    host."""
    t, k = top_i.shape
    dev = top_i.device
    local = top_i - first_expert
    key = torch.where((local >= 0) & (local < held), local, held).reshape(-1)
    order = torch.argsort(key, stable=True)
    inv = torch.empty_like(order).scatter_(0, order, torch.arange(t * k, device=dev))
    counts = (key[:, None] == torch.arange(held, device=dev)).sum(dim=0)
    return order, inv, counts, torch.cumsum(counts, dim=0).to(torch.int32)


# ---------------------------------------------------------------- plain versions

class _Dispatch(torch.autograd.Function):
    """The rows of ``x`` in expert order (row r holds token
    ``token_of_row[r]``).  The backward gathers each token's k rows through
    ``inv`` (the row of each choice) and sums those of held choices
    (``mine`` (T, k)) in the choices' order: no atomic adds, and the rows
    of choices not held, which the grouped products leave unwritten, are
    never read."""

    @staticmethod
    def forward(ctx, x, token_of_row, inv, mine):
        ctx.save_for_backward(inv, mine)
        return x.index_select(0, token_of_row)

    @staticmethod
    def backward(ctx, grad):
        inv, mine = ctx.saved_tensors
        t, k = mine.shape
        rows = grad.index_select(0, inv).view(t, k, -1)
        return torch.where(mine[..., None], rows, 0).sum(dim=1), None, None, None


def gather_ref(tokens, order, inv, offs, dtype):
    """Plain version of ``gather``: all T k rows, token ``order[r] // k`` in
    ``dtype``; autograd's backward through ``_Dispatch``."""
    k = order.numel() // tokens.shape[0]
    return _Dispatch.apply(tokens.to(dtype), order // k, inv, token_rows(inv, offs, k)[1])


def swiglu_ref(h1):
    """Plain version of ``swiglu``: ``silu(gate) * up`` over all rows."""
    gate, up = h1.chunk(2, dim=-1)
    return F.silu(gate) * up


def combine_ref(ys, w, inv, offs):
    """Plain version of ``combine``: every choice's row gathered back,
    masked to the held ones, weighted in float32 and summed over k."""
    t, k = w.shape
    back = torch.where(token_rows(inv, offs, k)[1][..., None], ys.index_select(0, inv).view(t, k, -1), 0)
    return torch.sum(back * w[..., None], dim=1)


def grad_w_atol(grad_out, ys, inv, mine):
    """The gate of the combine's gradient of the weights (T, k) against the
    plain version's: a float32 dot product over d summed in another order
    than PyTorch's, each order within d 2^-24 sum |g y| of the exact sum,
    so the two within twice that; 0 where a choice is not held."""
    t, k = mine.shape
    rows = ys.float().index_select(0, inv).view(t, k, -1)
    return torch.where(mine, 2 * ys.shape[-1] * 2.0**-24 * (grad_out[:, None, :] * rows).abs().sum(-1), 0.0)


# ---------------------------------------------------------------- index maps

def row_sources(order: torch.Tensor, k: int):
    """(token, choice) of each row: ``divmod(order[r], k)``, as the gather's
    kernel finds the token of row r."""
    return torch.div(order, k, rounding_mode="floor"), torch.remainder(order, k)


def token_rows(inv: torch.Tensor, offs: torch.Tensor, k: int):
    """(rows (T, k), held (T, k)): token t's rows ``inv[t k + j]`` and
    whether each is under n = offs[-1], as the per-token kernels (the
    gather's backward, the combine and its backward) visit them."""
    rows = inv.view(-1, k)
    return rows, rows < offs[-1]


# ---------------------------------------------------------------- checks

def _rows_ok(x: torch.Tensor) -> bool:
    """A 2-D tensor whose rows the kernels can move as 16-byte vectors:
    elements contiguous in a row, rows a multiple of 16 bytes apart, the
    start 16-byte aligned (empty tensors pass)."""
    if x.dim() != 2:
        return False
    if x.numel() == 0:
        return True
    vec = 16 // x.element_size()
    return (x.stride(1) == 1 and x.shape[1] % 8 == 0 and (x.shape[0] == 1 or x.stride(0) % vec == 0)
            and x.data_ptr() % 16 == 0)


def check_operands(kind: str, **ops) -> None:
    """Raise (ValueError, TypeError) unless the operands of pass ``kind``
    (``"gather"``: tokens, order, inv, offs, dtype; ``"swiglu"``: h1, offs;
    ``"combine"``: ys, w, inv, offs) are what the kernels take: one device,
    float32 tokens and weights, bf16 or float32 rows, int64 order and inv
    of T k entries, int32 ``offs`` (one entry or more, contiguous), k up to
    ``MAX_K``, widths multiples of 8, rows laid out for 16-byte vectors, and
    index arithmetic within 32 bits."""
    offs = ops["offs"]
    if offs.dtype != torch.int32 or offs.dim() != 1 or offs.numel() == 0 or not offs.is_contiguous():
        raise TypeError(f"moe_rows {kind}: offs must be a contiguous 1-D int32 tensor of the groups' "
                        f"ends, got {offs.dtype} {tuple(offs.shape)}")
    tensors = [v for v in ops.values() if isinstance(v, torch.Tensor)]
    if len({str(v.device) for v in tensors}) != 1:
        raise ValueError(f"moe_rows {kind}: operands on {sorted({str(v.device) for v in tensors})}")
    for name in ("order", "inv"):
        if name in ops and (ops[name].dtype != torch.int64 or ops[name].dim() != 1
                            or not ops[name].is_contiguous()):
            raise TypeError(f"moe_rows {kind}: {name} must be a contiguous 1-D int64 tensor")
    if kind == "gather":
        tokens, dtype = ops["tokens"], ops["dtype"]
        if tokens.dtype != torch.float32 or dtype not in ROW_DTYPES:
            raise TypeError(f"moe_rows gather: float32 tokens into bf16 or float32 rows, got "
                            f"{tokens.dtype} into {dtype}")
        t, rows = tokens.shape[0] if tokens.dim() == 2 else 0, ops["order"].numel()
        if not _rows_ok(tokens) or t == 0 or rows % t or ops["inv"].numel() != rows:
            raise ValueError(f"moe_rows gather: tokens (T, d) with d a multiple of 8 and order, inv of "
                             f"T k entries, got {tuple(tokens.shape)}, stride {tokens.stride()}, "
                             f"{rows} and {ops['inv'].numel()} entries")
        k, width = rows // t, tokens.shape[1]
    elif kind == "swiglu":
        h1 = ops["h1"]
        if h1.dtype not in ROW_DTYPES:
            raise TypeError(f"moe_rows swiglu: bf16 or float32 rows, got {h1.dtype}")
        if not _rows_ok(h1) or h1.shape[1] % 16:
            raise ValueError(f"moe_rows swiglu: [gate | up] rows (R, 2 f) with f a multiple of 8, got "
                             f"{tuple(h1.shape)}, stride {h1.stride()}")
        k, rows, width = 1, h1.shape[0], h1.shape[1]
    elif kind == "combine":
        ys, w = ops["ys"], ops["w"]
        if ys.dtype not in ROW_DTYPES or w.dtype != torch.float32:
            raise TypeError(f"moe_rows combine: bf16 or float32 rows and float32 weights, got "
                            f"{ys.dtype} and {w.dtype}")
        rows = ys.shape[0] if ys.dim() == 2 else -1
        if not _rows_ok(ys) or w.dim() != 2 or w.numel() != rows or ops["inv"].numel() != rows:
            raise ValueError(f"moe_rows combine: rows (T k, d) with d a multiple of 8, weights (T, k) "
                             f"and inv of T k entries, got {tuple(ys.shape)}, stride {ys.stride()}, "
                             f"{tuple(w.shape)} and {ops['inv'].numel()}")
        k, width = w.shape[1], ys.shape[1]
    else:
        raise ValueError(f"no moe_rows pass {kind!r}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"moe_rows {kind}: {k} choices a token, the kernels take 1 to {MAX_K}")
    if rows * max(width // 8, 1) > _INT32_MAX:
        raise ValueError(f"moe_rows {kind}: {rows} rows of {width} overflow the kernels' 32-bit index")


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
    obs.count("ops.moe_rows.launches")


def _last(offs: torch.Tensor) -> int:
    """The device address of n = offs[-1]."""
    return offs.data_ptr() + (offs.numel() - 1) * offs.element_size()


def _bf16(x: torch.Tensor) -> int:
    return int(x.dtype == torch.bfloat16)


def _vectors(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself where its rows take 16-byte vectors, else a contiguous
    copy (an incoming gradient laid out otherwise)."""
    return x if _rows_ok(x) else x.contiguous()


def launch_gather(tokens, order, offs, xs) -> None:
    """xs[r] = tokens[order[r] // k] for r < n; rows past n untouched."""
    k = order.numel() // tokens.shape[0]
    _call("moe_gather_launch", tokens.device, _bf16(xs), tokens.data_ptr(), tokens.stride(0),
          order.data_ptr(), k, _last(offs), xs.data_ptr(), xs.stride(0), xs.shape[0], xs.shape[1])


def launch_gather_backward(grad, inv, offs, out) -> None:
    """out[t] = the sum of token t's held rows of ``grad`` (float32)."""
    k = inv.numel() // out.shape[0]
    _call("moe_gather_backward_launch", grad.device, _bf16(grad), grad.data_ptr(), grad.stride(0),
          inv.data_ptr(), k, _last(offs), out.shape[0], out.data_ptr(), out.stride(0), out.shape[1])


def launch_swiglu(h1, offs, h) -> None:
    """h[r] = silu(gate) * up of h1[r] = [gate | up], r < n."""
    _call("moe_swiglu_launch", h1.device, _bf16(h1), h1.data_ptr(), h1.stride(0), _last(offs),
          h.shape[1], h.data_ptr(), h.stride(0), h.shape[0])


def launch_swiglu_backward(dh, h1, offs, dh1) -> None:
    """dh1[r] = [d gate | d up] of row r < n."""
    _call("moe_swiglu_backward_launch", dh.device, _bf16(h1), dh.data_ptr(), dh.stride(0),
          h1.data_ptr(), h1.stride(0), _last(offs), dh.shape[1], dh1.data_ptr(), dh1.stride(0),
          dh1.shape[0])


def launch_combine(ys, w, inv, offs, out) -> None:
    """out[t] = sum over token t's held choices of w[t, j] ys[inv[t k + j]]."""
    _call("moe_combine_launch", ys.device, _bf16(ys), ys.data_ptr(), ys.stride(0), w.data_ptr(),
          inv.data_ptr(), w.shape[1], _last(offs), w.shape[0], out.data_ptr(), out.stride(0),
          out.shape[1])


def launch_combine_backward(g, ys, w, inv, offs, grad_ys, grad_w) -> None:
    """grad_ys[inv[t k + j]] = w[t, j] g[t] and grad_w[t, j] = <g[t],
    ys[inv[t k + j]]> for held choices; grad_w 0 for the others."""
    _call("moe_combine_backward_launch", g.device, _bf16(ys), g.data_ptr(), g.stride(0), ys.data_ptr(),
          ys.stride(0), w.data_ptr(), inv.data_ptr(), w.shape[1], _last(offs), w.shape[0],
          grad_ys.data_ptr(), grad_ys.stride(0), grad_w.data_ptr(), ys.shape[1])


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tokens, order, inv, offs, dtype):
        ctx.save_for_backward(inv, offs)
        ctx.tokens_shape = tokens.shape
        xs = torch.empty((order.numel(), tokens.shape[1]), dtype=dtype, device=tokens.device)
        launch_gather(tokens, order, offs, xs)
        return xs

    @staticmethod
    def backward(ctx, grad):
        inv, offs = ctx.saved_tensors
        out = torch.empty(ctx.tokens_shape, dtype=torch.float32, device=grad.device)
        launch_gather_backward(_vectors(grad), inv, offs, out)
        return out, None, None, None, None


class _SwiGLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h1, offs):
        ctx.save_for_backward(h1, offs)
        h = torch.empty((h1.shape[0], h1.shape[1] // 2), dtype=h1.dtype, device=h1.device)
        launch_swiglu(h1, offs, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        h1, offs = ctx.saved_tensors
        dh1 = torch.empty(h1.shape, dtype=h1.dtype, device=h1.device)
        launch_swiglu_backward(_vectors(dh), h1, offs, dh1)
        return dh1, None


class _Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ys, w, inv, offs):
        w = w.contiguous()
        ctx.save_for_backward(ys, w, inv, offs)
        out = torch.empty((w.shape[0], ys.shape[1]), dtype=torch.float32, device=ys.device)
        launch_combine(ys, w, inv, offs, out)
        return out

    @staticmethod
    def backward(ctx, g):
        ys, w, inv, offs = ctx.saved_tensors
        grad_ys = torch.empty(ys.shape, dtype=ys.dtype, device=ys.device)
        grad_w = torch.empty(w.shape, dtype=torch.float32, device=w.device)
        launch_combine_backward(_vectors(g), ys, w, inv, offs, grad_ys, grad_w)
        return grad_ys, grad_w, None, None


def _on_card(x: torch.Tensor, name: str) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"moe_rows {name} runs on the CPU or a CUDA device, not {x.device}")
    return True


def gather(tokens, order, inv, offs, dtype):
    """The dispatch: (T k, d) rows in ``dtype``, row r < n token ``order[r]
    // k`` of the float32 ``tokens`` (T, d); differentiable in ``tokens``."""
    if not _on_card(tokens, "gather"):
        return gather_ref(tokens, order, inv, offs, dtype)
    check_operands("gather", tokens=tokens, order=order, inv=inv, offs=offs, dtype=dtype)
    return _Gather.apply(tokens, order, inv, offs, dtype)


def swiglu(h1, offs):
    """``silu(gate) * up`` of the rows r < n of ``h1`` (R, 2 f) = [gate |
    up]: (R, f); differentiable in ``h1``."""
    if not _on_card(h1, "swiglu"):
        return swiglu_ref(h1)
    check_operands("swiglu", h1=h1, offs=offs)
    return _SwiGLU.apply(h1, offs)


def combine(ys, w, inv, offs):
    """(T, d) float32: each token's held rows of ``ys`` (T k, d) weighted by
    ``w`` (T, k) and summed; differentiable in ``ys`` and ``w``."""
    if not _on_card(ys, "combine"):
        return combine_ref(ys, w, inv, offs)
    check_operands("combine", ys=ys, w=w, inv=inv, offs=offs)
    return _Combine.apply(ys, w, inv, offs)
