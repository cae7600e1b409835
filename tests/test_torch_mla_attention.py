"""MLA's attention core (``ops/mla_attention_cuda.py``) on the CPU: its plain
version against the chain ``MLA.forward`` ran inline before the core became
one call, ``MLA`` against that former forward (output and every gradient, to
the bit), and the wrapper's checks of what the CUDA kernels take.  The
kernels themselves are held to the plain version on the card
(``tests/test_torch_cuda.py``)."""
from dataclasses import replace

import numpy as np
import pytest
import torch

from diffusion_extensions_tpu_torch import obs
from diffusion_extensions_tpu_torch.models.deepseek_v2 import DEEPSEEK_V2_LITE, MLA
from diffusion_extensions_tpu_torch.models.layers import widen
from diffusion_extensions_tpu_torch.ops import mla_attention_cuda as mla

SMALL = replace(DEEPSEEK_V2_LITE, hidden_size=64, num_attention_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
                qk_rope_head_dim=8, v_head_dim=16)
B, N = 3, 20
DTYPES = {"float32": (torch.float32, False), "float64": (torch.float64, False),
          "bf16-autocast": (torch.float32, True)}


def _former_core(q, kv, k_pe, c):
    """The core as ``MLA.forward`` ran it inline: q (B, H, N, qk), kv (B,
    H, N, nope + v), k_pe (B, N, rope); o (B, N, H v)."""
    b, h, n, _ = q.shape
    nope, rope = c.qk_nope_head_dim, c.qk_rope_head_dim
    k_nope, v = kv.split([nope, c.v_head_dim], dim=-1)
    k = torch.cat((k_nope, k_pe[:, None].expand(b, h, n, rope).to(k_nope.dtype)), dim=-1)
    logits = widen(torch.matmul(q, k.transpose(-1, -2))) * c.softmax_scale
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(weights, v).transpose(1, 2).reshape(b, n, h * c.v_head_dim)


def _former_forward(m: MLA, x):
    """``MLA.forward`` before the core moved to ``mla_attention_cuda``."""
    c = m.cfg
    b, n, _ = x.shape
    h, nope, rope = c.num_attention_heads, c.qk_nope_head_dim, c.qk_rope_head_dim
    q = m.q_proj(x).view(b, n, h, nope + rope).transpose(1, 2)
    latent, k_pe = m.kv_a_proj_with_mqa(x).split([c.kv_lora_rank, rope], dim=-1)
    kv = m.kv_b_proj(m.kv_a_layernorm(latent)).view(b, n, h, nope + c.v_head_dim).transpose(1, 2)
    return m.o_proj(_former_core(q, kv, k_pe, c))


def _randn(seed, *shape, dtype=torch.float32):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)).to(dtype)


def _operands(c=SMALL, b=B, n=N, dtype=torch.float32, seed=0):
    """q, kv and k_pe as the projections lay them out: views of (B, N, H qk),
    (B, N, H (nope + v)) and the rope slice of (B, N, rank + rope)."""
    h, dqk = c.num_attention_heads, c.qk_nope_head_dim + c.qk_rope_head_dim
    q = _randn(seed, b, n, h * dqk, dtype=dtype).view(b, n, h, dqk)
    kv = _randn(seed + 1, b, n, h * (c.qk_nope_head_dim + c.v_head_dim), dtype=dtype).view(b, n, h, -1)
    k_pe = _randn(seed + 2, b, n, c.kv_lora_rank + c.qk_rope_head_dim, dtype=dtype)[..., c.kv_lora_rank:]
    return q, kv, k_pe


def _autocast(on):
    return torch.autocast("cpu", dtype=torch.bfloat16, enabled=on)


@pytest.mark.parametrize("case", list(DTYPES))
def test_attention_ref_is_the_former_chain_to_the_bit(case):
    """``attention_ref`` on the projections' layouts, reshaped as ``MLA``
    reshapes it, gives the bits of the former inline chain, and so does its
    gradient of each input."""
    dtype, bf16 = DTYPES[case]
    outs = []
    for fn in ("ref", "former"):
        q, kv, k_pe = (x.clone().requires_grad_(True) for x in _operands(dtype=dtype))
        with _autocast(bf16):
            if fn == "ref":
                o = mla.attention_ref(q, kv, k_pe, SMALL.softmax_scale).reshape(B, N, -1)
            else:
                o = _former_core(q.transpose(1, 2), kv.transpose(1, 2), k_pe, SMALL)
        grads = torch.autograd.grad(o, [q, kv, k_pe], _randn(9, *o.shape, dtype=o.dtype))
        outs.append((o, *grads))
    assert outs[0][0].dtype == (torch.bfloat16 if bf16 else dtype)
    for got, want in zip(*outs):
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("case", list(DTYPES))
def test_mla_output_and_gradients_are_the_former_forwards(case):
    """``MLA.forward`` on the CPU gives the output and every gradient (the
    input's and each weight's) of the former forward, to the bit."""
    dtype, bf16 = DTYPES[case]
    torch.manual_seed(0)
    m = MLA(SMALL).to(dtype)
    x = _randn(5, B, N, SMALL.hidden_size, dtype=dtype)
    g = _randn(6, B, N, SMALL.hidden_size)
    outs = []
    for fn in (m.forward, lambda t: _former_forward(m, t)):
        xx = x.clone().requires_grad_(True)
        with _autocast(bf16):
            y = fn(xx)
        grads = torch.autograd.grad(y, [xx, *m.parameters()], g.to(y.dtype))
        outs.append((y, *grads))
    for got, want in zip(*outs):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_attention_takes_the_plain_version_on_the_cpu():
    """On the CPU the wrapper is ``attention_ref`` (float64 too), launches
    nothing and builds nothing."""
    before = obs.counter("ops.mla_attention.launches")
    for dtype in (torch.float32, torch.float64):
        q, kv, k_pe = _operands(dtype=dtype, seed=4)
        got = mla.attention(q, kv, k_pe, SMALL.softmax_scale)
        assert got.shape == (B, N, SMALL.num_attention_heads, SMALL.v_head_dim) and got.dtype == dtype
        assert torch.equal(got, mla.attention_ref(q, kv, k_pe, SMALL.softmax_scale))
    assert obs.counter("ops.mla_attention.launches") == before
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        mla.attention(*(x.to("meta") for x in _operands()), SMALL.softmax_scale)


# the cell's heads (16 of 128 + 64, v 128) and the card tests' small trunk's
# (4 of 32 + 16, v 32), bf16 as autocast makes them
CELL = replace(DEEPSEEK_V2_LITE, num_attention_heads=16)
CARD_SMALL = replace(DEEPSEEK_V2_LITE, num_attention_heads=4, qk_nope_head_dim=32, qk_rope_head_dim=16,
                     v_head_dim=32, kv_lora_rank=64)


@pytest.mark.parametrize("c,n", [(CELL, 256), (CELL, 200), (CARD_SMALL, 32), (CARD_SMALL, 1)],
                         ids=["cell", "cell-ragged", "small", "small-one-point"])
def test_operand_checks_accept_the_layers_operands(c, n):
    """The operands ``MLA`` hands over, at every head dims of
    ``HEAD_DIMS``: strided views of the projections' rows pass."""
    q, kv, k_pe = _operands(c, b=2, n=n, dtype=torch.bfloat16)
    assert not k_pe.is_contiguous()
    mla.check_operands(q, kv, k_pe)


def _bad(case):
    q, kv, k_pe = _operands(CARD_SMALL, b=2, n=8, dtype=torch.bfloat16)
    b, n, h, dqk = q.shape
    if case == "float32":
        return (q.float(), kv.float(), k_pe.float()), TypeError, "--bf16"
    if case == "float16":
        return (q.half(), kv.half(), k_pe.half()), TypeError, "bf16"
    if case == "mixed-dtypes":
        return (q, kv, k_pe.double()), TypeError, "bf16"
    if case == "head-dims":
        q2, kv2, kpe2 = _operands(SMALL, b=2, n=8, dtype=torch.bfloat16)
        return (q2, kv2, kpe2), ValueError, r"\(192, 64, 128\)"
    if case == "v-dims":
        return (q, torch.cat((kv, kv[..., :16]), dim=-1), k_pe), ValueError, "head dims"
    if case == "heads-differ":
        return (q, kv[:, :, :2], k_pe), ValueError, "kv"
    if case == "k_pe-batch":
        return (q, kv, k_pe[:1]), ValueError, "k_pe"
    if case == "q-rank":
        return (q.reshape(b, n, -1), kv, k_pe), ValueError, "q"
    if case == "last-stride":
        wide = torch.zeros(b, n, h, dqk, 2, dtype=torch.bfloat16)[..., 0]
        return (wide, kv, k_pe), ValueError, "stride"
    if case == "row-stride":
        rows = torch.zeros(b, n, h * dqk + 4, dtype=torch.bfloat16)[..., :h * dqk].view(b, n, h, dqk)
        return (rows, kv, k_pe), ValueError, "stride"
    if case == "misaligned-start":
        flat = torch.zeros(b * n * h * dqk + 8, dtype=torch.bfloat16)
        return (flat[1:1 + b * n * h * dqk].view(b, n, h, dqk), kv, k_pe), ValueError, "bytes off"
    if case == "too-many-clouds":
        big = torch.zeros(1, n, h, dqk, dtype=torch.bfloat16).expand(70_000, n, h, dqk)
        return (big, kv[:1].expand(70_000, -1, -1, -1), k_pe[:1].expand(70_000, -1, -1)), ValueError, "65535"
    if case == "two-devices":
        return (q, kv, k_pe.to("meta")), ValueError, "meta"
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["float32", "float16", "mixed-dtypes", "head-dims", "v-dims", "heads-differ",
                                  "k_pe-batch", "q-rank", "last-stride", "row-stride", "misaligned-start",
                                  "too-many-clouds", "two-devices"])
def test_operand_checks_refuse_what_the_kernels_cannot_take(case):
    """Each layout, dtype or head dims the kernels do not take raises: float32
    names ``--bf16``, other head dims name the ones built."""
    ops, error, match = _bad(case)
    with pytest.raises(error, match=match):
        mla.check_operands(*ops)


def test_head_dims_are_the_configurations():
    """``HEAD_DIMS`` holds the published trunk's heads and the card tests'
    small trunk's: (qk, rope, v)."""
    for c in (DEEPSEEK_V2_LITE, CARD_SMALL):
        assert (c.qk_nope_head_dim + c.qk_rope_head_dim, c.qk_rope_head_dim, c.v_head_dim) in mla.HEAD_DIMS
    assert set(mla.GATES) == {"o", "dq", "dkv", "dk_pe"}
