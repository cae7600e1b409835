"""KDA's chunked gated delta rule around its CUDA kernels (``ops/kda_cuda.py``,
``models/kimi_linear.py`` ``chunk_kda``), on the CPU: the plain version is
the former chain to the bit, the CPU takes it, the operand checks accept
what the mixer hands over and refuse what the kernels cannot take, and the
kernels' arithmetic (``kernel_math_ref``: their blocks, levels,
substitutions and every gradient written out) equals autograd of the plain
chain in float64.  The kernels themselves run in ``tests/test_torch_cuda.py``."""
import os
import sys
from dataclasses import replace

import pytest
import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from diffusion_extensions_tpu_torch import obs  # noqa: E402
from diffusion_extensions_tpu_torch.models import kimi_linear  # noqa: E402
from diffusion_extensions_tpu_torch.models.kimi_linear import (  # noqa: E402
    KIMI_LINEAR_48B, KimiDeltaAttention, chunk_kda, chunk_kda_ref)
from diffusion_extensions_tpu_torch.ops import kda_cuda  # noqa: E402

OUTPUTS = ("o", "dq", "dk", "dv", "dg", "dbeta")


def _former_chunk_kda(q, k, v, g, beta, chunk=64):
    """``chunk_kda`` as the trunk ran it before the kernels, kept here as
    written then."""
    with torch.autocast(q.device.type, enabled=False):
        args = tuple(x.float() for x in (q, k, v, g, beta))
        if torch.is_grad_enabled() and any(x.requires_grad for x in args):
            return checkpoint(kimi_linear._chunks, *args, chunk, use_reentrant=False, preserve_rng_state=False)
        return kimi_linear._chunks(*args, chunk)


def _inputs(n, d=8, dv=None, b=2, h=3, seed=0, dtype=torch.float64, decay="cell"):
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, dtype=dtype)

    q = F.normalize(rnd(b, h, n, d), dim=-1) * d ** -0.5
    k = F.normalize(rnd(b, h, n, d), dim=-1)
    x = rnd(b, h, n, d)
    g = -torch.exp(x * 2 - 1) if decay == "cell" else -(7 + 13 * torch.sigmoid(x))
    beta = torch.sigmoid(rnd(b, h, n))
    return [q, k, rnd(b, h, n, dv or d), g, beta], rnd(b, h, n, dv or d)


def _run(fn, xs, grad):
    ins = [x.detach().clone().requires_grad_(True) for x in xs]
    o = fn(*ins)
    return dict(zip(OUTPUTS, (o.detach(), *torch.autograd.grad(o, ins, grad.to(o.dtype)))))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [37, 130])
def test_plain_version_is_the_former_chain_to_the_bit(dtype, n):
    xs, grad = _inputs(n, dtype=dtype)
    got, want = _run(chunk_kda_ref, xs, grad), _run(_former_chunk_kda, xs, grad)
    for key in OUTPUTS:
        assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key


def test_the_cpu_takes_the_plain_version(monkeypatch):
    """On the CPU ``chunk_kda`` is ``chunk_kda_ref`` to the bit, forward and
    backward, and never reaches the kernels' wrapper."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU reached the kernels' wrapper")

    monkeypatch.setattr(kda_cuda, "chunk_kda", refuse)
    before = obs.counter("ops.kda.launches")
    xs, grad = _inputs(100, dtype=torch.float32)
    got, want = _run(chunk_kda, xs, grad), _run(chunk_kda_ref, xs, grad)
    for key in OUTPUTS:
        assert torch.equal(got[key], want[key]), key
    assert obs.counter("ops.kda.launches") == before


def _mixer_operands(head_dim, n, heads=2):
    """What ``KimiDeltaAttention.forward`` hands to ``chunk_kda``: q, k, v, g
    viewed (B, H, N, d) from (B, N, H, d) rows, beta (B, H, N) from (B, N,
    H)."""
    cfg = replace(KIMI_LINEAR_48B, hidden_size=64, linear_attn_num_heads=heads, linear_attn_head_dim=head_dim)
    seen = []

    def spy(*args):
        seen.append(args)
        return chunk_kda_ref(*args)

    layer = KimiDeltaAttention(cfg, 0)
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(kimi_linear, "chunk_kda", spy)
        layer(torch.randn(2, n, 64, generator=torch.Generator().manual_seed(n)))
    return seen[0]


@pytest.mark.parametrize("head_dim,n", [(128, 64), (32, 130), (32, 1), (128, 170)])
def test_checks_accept_the_mixers_operands(head_dim, n):
    """The cell's heads (128) and the small trunk's (32), whole and ragged
    chunks, at the strides the mixer leaves them: (B, N, H, d) rows, so
    nothing is copied before the kernels."""
    q, k, v, g, beta, chunk = _mixer_operands(head_dim, n)
    b, h = q.shape[:2]
    for x in (q, k, v, g):
        assert x.shape == (b, h, n, head_dim) and x.stride() == (n * h * head_dim, head_dim, h * head_dim, 1)
    assert beta.stride() == (n * h, 1, h)
    kda_cuda.check_operands(q, k, v, g, beta, chunk)


def test_checks_refuse_what_the_kernels_cannot_take():
    xs, _ = _inputs(70, d=32, dtype=torch.float32)
    q, k, v, g, beta = xs
    with pytest.raises(TypeError, match="float32"):
        kda_cuda.check_operands(*(x.double() for x in xs))
    with pytest.raises(TypeError, match="float32"):
        kda_cuda.check_operands(*(x.bfloat16() for x in xs))
    with pytest.raises(ValueError, match="head dims"):
        kda_cuda.check_operands(*_inputs(70, d=64, dtype=torch.float32)[0])
    with pytest.raises(ValueError, match="head dims"):
        kda_cuda.check_operands(q, k, v[..., :16], g, beta)
    with pytest.raises(ValueError, match="chunks of 32"):
        kda_cuda.check_operands(*xs, 32)
    with pytest.raises(ValueError, match="B, H, N"):
        kda_cuda.check_operands(q, k[:, :, 1:], v, g, beta)
    with pytest.raises(ValueError, match="B, H, N"):
        kda_cuda.check_operands(q, k, v, g, beta[..., None])
    with pytest.raises(ValueError, match="16-byte"):
        kda_cuda.check_operands(q, k, v, torch.empty(g.numel() + 1)[1:].view(g.shape), beta)
    with pytest.raises(ValueError, match="16-byte"):
        kda_cuda.check_operands(q.transpose(2, 3).contiguous().transpose(2, 3), k, v, g, beta)
    wide = [x[:1].expand(65536, *x.shape[1:]) for x in xs]
    with pytest.raises(ValueError, match="65535"):
        kda_cuda.check_operands(*wide)
    with pytest.raises(ValueError, match="kernels run on a CUDA device"):
        kda_cuda.chunk_kda(*xs)


def test_scratch_holds_a_chunk_per_head_and_cloud():
    q = torch.empty(3, 5, 130, 32)
    shapes = kda_cuda.scratch_shapes(q)
    assert shapes["w"] == shapes["u"] == shapes["vnew"] == shapes["dvnew"] == (3 * 5 * 3, 64, 32)
    assert shapes["p"] == shapes["abar"] == (45, 64, 64) and shapes["states"] == shapes["dstates"] == (45, 32, 32)


@pytest.mark.parametrize("n,d,dv,decay", [(1, 8, 8, "cell"), (37, 4, 6, "cell"), (64, 8, 8, "cell"),
                                          (130, 8, 10, "cell"), (200, 16, 16, "cell"), (170, 32, 32, "strong")])
def test_kernel_arithmetic_is_autograd_of_the_plain_chain(n, d, dv, decay):
    """``kernel_math_ref`` (the kernels' forward and hand-written backward)
    against the plain chain and autograd, in float64: output and every
    input gradient to rounding."""
    xs, grad = _inputs(n, d=d, dv=dv, seed=n, decay=decay)
    want = _run(lambda *a: kimi_linear._chunks(*a, 64), xs, grad)
    got = dict(zip(OUTPUTS, kda_cuda.kernel_math_ref(*xs, grad)))
    for key in OUTPUTS:
        scale = float(want[key].abs().max())
        assert got[key].shape == want[key].shape, key
        assert float((got[key] - want[key]).abs().max()) <= 1e-12 * max(scale, 1.0), key


def test_kernel_arithmetic_takes_only_non_positive_exponents(monkeypatch):
    """Every exp the kernels' arithmetic takes has a non-positive argument
    (later-minus-earlier decays, through a block's boundary across blocks),
    also where the decays reach e^-20 a point."""
    seen = []
    exp = torch.exp

    def watch(x, *args, **kwargs):
        seen.append(float(x.max()))
        return exp(x, *args, **kwargs)

    monkeypatch.setattr(torch, "exp", watch)
    xs, grad = _inputs(150, d=16, seed=5, decay="strong")
    out = kda_cuda.kernel_math_ref(*xs, grad)
    assert seen and max(seen) <= 0.0
    assert all(torch.isfinite(x).all() for x in out)
