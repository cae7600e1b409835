"""Kimi Delta Attention's chunked gated delta rule: the hand-written CUDA
kernels, the wrapper ``models/kimi_linear.py``'s ``chunk_kda`` calls on the
card, and a CPU mirror of the kernels' arithmetic.

Replaces no TPU kernel: the JAX package has no Kimi Linear trunk.  Per head,
from S = 0 over the N points,

    S <- Diag(exp(g_t)) S;  S <- S + beta_t k_t (v_t - S^T k_t)^T;  o_t = S^T q_t

with q, k, g (B, H, N, dk), v (B, H, N, dv) and beta (B, H, N), in float32.
On the card ``chunk_kda`` runs ``csrc/kda_chunk.cu`` in chunks of
``CHUNK`` points: two launches forward (the intra-chunk matrices, then the
state pass writing o), four backward (the intra-chunk matrices and the
state pass again, the reverse state pass, then each chunk's gradients),
every product in float32 on the FMA units.  It reads the operands in place
at their strides (the mixer's (B, N, H, d) rows viewed as (B, H, N, d)),
returns o as a (B, H, N, dv) view of a (B, N, H, dv) tensor, and the
gradients likewise; the backward recomputes what it needs from the saved
inputs (nothing beyond them is kept between forward and backward).

The kernels take float32 and dk = dv in ``HEAD_DIMS`` at chunks of 64;
``check_operands`` raises on anything else, and a CUDA tensor is never
handed to the plain chain (``kimi_linear.chunk_kda_ref``, which the CPU
takes).  ``kernel_math_ref`` repeats the kernels' decomposition (the diagonal
blocks of 16 points forward and 4 backward, the halving levels above them,
the substitutions, the reverse state pass, every gradient written out) in PyTorch over whole tensors, so
the CPU tests hold its forward and backward to autograd of the plain chain.

``_build.build_library`` compiles the source for sm_90a at the first call on
the card; the launches run through ``ctypes`` on PyTorch's current stream.
The counter ``ops.kda.launches`` (``obs.count``) counts launches: two a
forward, four a backward (inside a captured CUDA graph once, at capture).
"""
from __future__ import annotations

import ctypes

import torch

from .. import obs
from ._build import CSRC, build_library

__all__ = ["chunk_kda", "check_operands", "launch_forward", "launch_backward", "kernel_math_ref", "build",
           "CHUNK", "HEAD_DIMS", "GATES", "LAUNCHES"]

SOURCE = CSRC / "kda_chunk.cu"
CHUNK = 64
# dk = dv the kernels are built for: Kimi-Linear-48B-A3B's, and the card
# tests' small trunk's
HEAD_DIMS = (128, 32)
# each output's gate (rtol, atol) against the plain version on the card (the
# same float32 inputs).  What parts the two is the plain version's rounding:
# it rounds the in-chunk cumulative decays G to float32 (~|G| 2^-24 in every
# exp, |G| up to ~1e3 at the tests' tail of e^-20 a point), which the
# kernels sum in float64 and keep as hi + lo, so they lie ~10x closer to a
# float64 evaluation.  Measured at the kimilinear-aircraft-train cell's shape
# (16 x 32 heads x 1,024 points): |kernel - plain| up to 5e-6 (o), 2.4e-3
# (dq, |dq| < 13), 1.3e-4 (dk), 3e-6 (dv), 1.5e-5 (dg), 1.7e-5 (dbeta)
GATES = {"o": (1e-3, 3e-5), "dq": (1e-3, 1e-2), "dk": (1e-3, 1e-3), "dv": (1e-3, 3e-5), "dg": (1e-3, 1e-4),
         "dbeta": (1e-3, 2e-4)}
LAUNCHES = {"forward": 2, "backward": 4}
_MAX_GRID = 65535
# the diagonal blocks computed directly (forward, backward), below the
# halving levels
_SUB, _SUB_BACKWARD = 16, 4

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
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.kda_forward.argtypes = [i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr]
    lib.kda_backward.argtypes = [i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr]
    for fn in (lib.kda_forward, lib.kda_backward):
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


# ---------------------------------------------------------------- checks

def _rows_ok(x: torch.Tensor) -> bool:
    """Unit stride in the last dim, every other stride and the start a
    multiple of 16 bytes: the kernels move rows as 16-byte vectors."""
    return x.stride(-1) == 1 and all(s % 4 == 0 for s in x.stride()[:-1]) and x.data_ptr() % 16 == 0


def check_operands(q, k, v, g, beta, chunk: int = CHUNK) -> None:
    """Raise (TypeError, ValueError) unless ``q``, ``k``, ``g`` (B, H, N,
    dk), ``v`` (B, H, N, dv) and ``beta`` (B, H, N) are what the kernels
    take: float32, one device, dk = dv in ``HEAD_DIMS``, chunks of
    ``CHUNK``, B and H at most 65,535, N at least 1, rows laid out for
    16-byte vectors (unit stride last, the other strides and the starts
    multiples of 4 elements; beta at any strides)."""
    tensors = {"q": q, "k": k, "v": v, "g": g, "beta": beta}
    dtypes = {name: x.dtype for name, x in tensors.items()}
    if any(dt != torch.float32 for dt in dtypes.values()):
        raise TypeError(f"kda: the kernels take float32 operands, got {dtypes}")
    if len({str(x.device) for x in tensors.values()}) != 1:
        raise ValueError(f"kda: operands on {sorted({str(x.device) for x in tensors.values()})}")
    if q.dim() != 4 or k.shape != q.shape or g.shape != q.shape or v.dim() != 4 or v.shape[:3] != q.shape[:3] \
            or beta.shape != q.shape[:3]:
        raise ValueError(f"kda: q, k, g (B, H, N, dk), v (B, H, N, dv) and beta (B, H, N), got "
                         f"{[tuple(x.shape) for x in tensors.values()]}")
    b, h, n, dk = q.shape
    if dk != v.shape[3] or dk not in HEAD_DIMS:
        raise ValueError(f"kda: head dims (dk, dv) = ({dk}, {v.shape[3]}); the kernels are built for dk = dv "
                         f"in {list(HEAD_DIMS)}")
    if chunk != CHUNK:
        raise ValueError(f"kda: chunks of {chunk} points; the kernels take {CHUNK}")
    if not (1 <= b <= _MAX_GRID and 1 <= h <= _MAX_GRID and n >= 1):
        raise ValueError(f"kda: B {b} and H {h} from 1 to {_MAX_GRID}, N {n} at least 1")
    for name, x in tensors.items():
        if name != "beta" and not _rows_ok(x):
            raise ValueError(f"kda: {name} rows not laid out for 16-byte vectors: stride {x.stride()}, "
                             f"start {x.data_ptr() % 16} bytes off")


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


def _operands(q, k, v, g, beta) -> tuple:
    """The launch functions' leading arguments: d, B, N, H, the five
    operands' pointers and their (b, h, n) strides."""
    xs = (q, k, v, g, beta)
    b, h, n, d = q.shape
    return (d, b, n, h, (ctypes.c_void_p * 5)(*(x.data_ptr() for x in xs)),
            (ctypes.c_longlong * 15)(*(s for x in xs for s in x.stride()[:3])))


def scratch_shapes(q) -> dict:
    """The backward's scratch (the forward uses the first three): per chunk
    W, U, P, A / beta, the starting state, v_new, dS' and dv_new."""
    b, h, n, d = q.shape
    m = b * h * -(-n // CHUNK)
    return {"w": (m, CHUNK, d), "u": (m, CHUNK, d), "p": (m, CHUNK, CHUNK), "abar": (m, CHUNK, CHUNK),
            "states": (m, d, d), "vnew": (m, CHUNK, d), "dstates": (m, d, d), "dvnew": (m, CHUNK, d)}


def launch_forward(q, k, v, g, beta, o, w, u, p) -> None:
    """o (B, N, H, dv), contiguous; w, u, p scratch of ``scratch_shapes``."""
    _call("kda_forward", q.device, *_operands(q, k, v, g, beta), o.data_ptr(), w.data_ptr(), u.data_ptr(),
          p.data_ptr())
    obs.count("ops.kda.launches", LAUNCHES["forward"])


def launch_backward(q, k, v, g, beta, grad_o, scratch: dict, dq, dk, dv, dg, dbeta) -> None:
    """From the forward's inputs and grad_o (B, H, N, dv) at its strides (rows
    as ``check_operands`` asks): dq, dk, dv, dg (B, N, H, d) and dbeta (B, N,
    H), contiguous; ``scratch`` of ``scratch_shapes``."""
    do_strides = (ctypes.c_longlong * 3)(*grad_o.stride()[:3])
    bufs = (ctypes.c_void_p * 8)(*(scratch[name].data_ptr() for name in scratch_shapes(q)))
    _call("kda_backward", q.device, *_operands(q, k, v, g, beta), grad_o.data_ptr(), do_strides, bufs,
          dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dg.data_ptr(), dbeta.data_ptr())
    obs.count("ops.kda.launches", LAUNCHES["backward"])


def _bnhd(b, h, n, d, like):
    """A (B, N, H, d) float32 tensor seen as (B, H, N, d)."""
    return torch.empty((b, n, h, d), dtype=torch.float32, device=like.device).transpose(1, 2)


class _ChunkKDA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, g, beta):
        b, h, n, d = q.shape
        o = _bnhd(b, h, n, d, q)
        shapes = scratch_shapes(q)
        w, u, p = (torch.empty(shapes[x], dtype=torch.float32, device=q.device) for x in ("w", "u", "p"))
        launch_forward(q, k, v, g, beta, o, w, u, p)
        ctx.save_for_backward(q, k, v, g, beta)
        return o

    @staticmethod
    def backward(ctx, grad_o):
        q, k, v, g, beta = ctx.saved_tensors
        b, h, n, d = q.shape
        if grad_o.dtype != torch.float32 or not _rows_ok(grad_o):
            grad_o = grad_o.float().contiguous()
        scratch = {name: torch.empty(shape, dtype=torch.float32, device=q.device)
                   for name, shape in scratch_shapes(q).items()}
        dq, dk, dv, dg = (_bnhd(b, h, n, d, q) for _ in range(4))
        dbeta = torch.empty((b, n, h), dtype=torch.float32, device=q.device).transpose(1, 2)
        launch_backward(q, k, v, g, beta, grad_o, scratch, dq, dk, dv, dg, dbeta)
        return dq, dk, dv, dg, dbeta


def chunk_kda(q, k, v, g, beta, chunk: int = CHUNK) -> torch.Tensor:
    """o (B, H, N, dv) of the gated delta rule on the card (a view of a (B,
    N, H, dv) tensor), differentiable in every operand; raises on what the
    kernels do not take (``check_operands``)."""
    if q.device.type != "cuda":
        raise ValueError(f"kda: the kernels run on a CUDA device, not {q.device}")
    check_operands(q, k, v, g, beta, chunk)
    return _ChunkKDA.apply(q, k, v, g, beta)


# ---------------------------------------------------------------- the kernels' arithmetic on the CPU

def _in_chunks(x: torch.Tensor, nc: int) -> torch.Tensor:
    """(B, H, N, d) -> (B, H, nc, CHUNK, d), zeros past N."""
    return torch.nn.functional.pad(x, (0, 0, 0, nc * CHUNK - x.shape[2])).unflatten(2, (nc, CHUNK))


def _levels(smallest):
    """The kernels' halving levels from 32 down to ``smallest``: (s, rows of
    the later halves, each row's boundary r)."""
    for s in (32, 16, 8, 4):
        if s < smallest:
            return
        rows = torch.arange(CHUNK)
        later = (rows // s) % 2 == 1
        yield s, later, (rows // (2 * s)) * (2 * s) + s - 1


def _pairs(q, k, G):
    """P (j <= i) and A / beta (j < i) as the intra kernel builds them: the
    16-point diagonal blocks directly, the levels through their boundaries."""
    blk = torch.arange(CHUNK) // _SUB
    same = blk[:, None] == blk[None, :]
    tril = torch.ones(CHUNK, CHUNK, dtype=torch.bool).tril()
    e = torch.exp((G[..., :, None, :] - G[..., None, :, :]).masked_fill(~(same & tril)[..., None], 0.0))
    kj = k[..., None, :, :] * e
    P = torch.where(same & tril, (q[..., :, None, :] * kj).sum(-1), 0.0)
    Ab = torch.where(same & tril.tril(-1), (k[..., :, None, :] * kj).sum(-1), 0.0)
    for s, later, r in _levels(_SUB):
        Gr = G[..., r, :]
        kx = k * torch.exp(torch.where(later[:, None], G - Gr, Gr - G))
        qx = q * torch.exp(torch.where(later[:, None], G - Gr, 0.0))
        pair = later[:, None] & ~later[None, :] & ((torch.arange(CHUNK)[:, None] // (2 * s)) ==
                                                   (torch.arange(CHUNK)[None, :] // (2 * s)))
        P = torch.where(pair, qx @ kx.transpose(-1, -2), P)
        Ab = torch.where(pair, kx @ kx.transpose(-1, -2), Ab)
    return P, Ab


def kernel_math_ref(q, k, v, g, beta, grad_o):
    """The kernels' forward and backward in PyTorch: o and the gradients
    (dq, dk, dv, dg, dbeta) of sum(o * grad_o), each as the kernels compute
    it (no autograd), over (B, H, N, d) operands in their dtype."""
    b, h, n, dk = q.shape
    nc = -(-n // CHUNK)
    q, k, v, g, dO = (_in_chunks(x, nc) for x in (q, k, v, g, grad_o))
    beta = _in_chunks(beta[..., None], nc)
    eye = torch.eye(CHUNK, dtype=q.dtype)
    # kda_intra
    G = g.cumsum(-2)
    P, Ab = _pairs(q, k, G)
    A = beta * Ab
    eG = torch.exp(G)
    W, U = torch.linalg.solve_triangular(eye + A, torch.cat((beta * k * eG, beta * v), -1), upper=False,
                                         unitriangular=True).split([dk, v.shape[-1]], -1)
    QG, KD, eL = q * eG, k * torch.exp(G[..., -1:, :] - G), torch.exp(G[..., -1, :])
    # kda_state: o, each chunk's starting state and v_new
    S = q.new_zeros(b, h, dk, v.shape[-1])
    o, states, vnew = [], [], []
    for c in range(nc):
        states.append(S)
        vnew.append(U[:, :, c] - W[:, :, c] @ S)
        o.append(QG[:, :, c] @ S + P[:, :, c] @ vnew[-1])
        S = eL[:, :, c, :, None] * S + KD[:, :, c].transpose(-1, -2) @ vnew[-1]
    states, vnew = torch.stack(states, 2), torch.stack(vnew, 2)
    # kda_state_backward: dS' and dv_new
    dS = torch.zeros_like(S)
    dstates, dvnew = [None] * nc, [None] * nc
    for c in reversed(range(nc)):
        dstates[c] = dS
        dvnew[c] = P[:, :, c].transpose(-1, -2) @ dO[:, :, c] + KD[:, :, c] @ dS
        dS = eL[:, :, c, :, None] * dS + QG[:, :, c].transpose(-1, -2) @ dO[:, :, c] \
            - W[:, :, c].transpose(-1, -2) @ dvnew[c]
    dstates, dvnew = torch.stack(dstates, 2), torch.stack(dvnew, 2)
    # kda_chunk_backward
    dQG = dO @ states.transpose(-1, -2)
    dq = dQG * eG
    dG = dQG * QG
    X = torch.linalg.solve_triangular((eye + A).transpose(-1, -2),
                                      torch.cat((dvnew, -dvnew @ states.transpose(-1, -2)), -1),
                                      upper=True, unitriangular=True)
    dbv, dbkg = X.split([v.shape[-1], dk], -1)
    dv = beta * dbv
    dbeta = (dbv * v).sum(-1) + (dbkg * k * eG).sum(-1)
    dk_ = beta * dbkg * eG
    dG = dG + beta * dbkg * k * eG
    dA = -torch.tril(dbv @ U.transpose(-1, -2) + dbkg @ W.transpose(-1, -2), -1)
    dbeta = dbeta + (dA * Ab).sum(-1)
    dAb = beta * dA
    dP = torch.tril(dO @ vnew.transpose(-1, -2))
    # through P and A / beta: the diagonal blocks, then the levels
    # (the pair (i, i) takes no decay, so it adds to dq and dk and not to dG)
    blk = torch.arange(CHUNK) // _SUB_BACKWARD
    same = (blk[:, None] == blk[None, :]) & torch.ones(CHUNK, CHUNK, dtype=torch.bool).tril(-1)
    e = torch.exp((G[..., :, None, :] - G[..., None, :, :]).masked_fill(~same[..., None], 0.0))
    dPd, dAd = torch.where(same, dP, 0.0), torch.where(same, dAb, 0.0)
    tq = (dPd[..., None] * k[..., None, :, :] * e).sum(-2)
    tk = (dAd[..., None] * k[..., None, :, :] * e).sum(-2)
    tc = ((dAd[..., None] * k[..., :, None, :] + dPd[..., None] * q[..., :, None, :]) * e).sum(-3)
    dii = dP.diagonal(0, -2, -1)[..., None]
    dq, dk_, dG = dq + tq + dii * k, dk_ + tk + tc + dii * q, dG + q * tq + k * tk - k * tc
    for s, later, r in _levels(_SUB_BACKWARD):
        Gr = G[..., r, :]
        own = torch.exp(torch.where(later[:, None], G - Gr, Gr - G))
        kx, qx = k * own, q * own
        pair = later[:, None] & ~later[None, :] & ((torch.arange(CHUNK)[:, None] // (2 * s)) ==
                                                   (torch.arange(CHUNK)[None, :] // (2 * s)))
        dPl, dAl = torch.where(pair, dP, 0.0), torch.where(pair, dAb, 0.0)
        tq, tk = (dPl @ kx) * own, (dAl @ kx) * own
        tc = (dAl.transpose(-1, -2) @ kx + dPl.transpose(-1, -2) @ qx) * own
        dq, dk_, dG = dq + tq, dk_ + tk + tc, dG + q * tq + k * tk - k * tc
    dKD = vnew @ dstates.transpose(-1, -2)
    dk_ = dk_ + dKD * torch.exp(G[..., -1:, :] - G)
    dG = dG - dKD * KD
    dGl = (dKD * KD).sum(-2) + (states * dstates).sum(-1) * eL
    dG = torch.cat((dG[..., :-1, :], dG[..., -1:, :] + dGl[..., None, :]), -2)
    dg = dG.flip(-2).cumsum(-2).flip(-2)

    def out(x):
        return x.flatten(2, 3)[:, :, :n]

    return (out(torch.stack(o, 2)), out(dq), out(dk_), out(dv), out(dg), out(dbeta[..., None])[..., 0])
