"""The experts layer's row passes (``ops/moe_rows_cuda.py``) on the CPU: the
plain versions against the layer's former PyTorch chain, the index maps the
kernels use against the plain path on random routings, and the operand
checks the wrapper runs before a launch.  The kernels themselves run in
``tests/test_torch_cuda.py`` (card only)."""
from dataclasses import replace

import numpy as np
import pytest
import torch
from torch.nn import functional as F

from diffusion_extensions_tpu_torch.models.deepseek_v2 import DEEPSEEK_V2_LITE, DeepSeekMoE
from diffusion_extensions_tpu_torch.ops import moe_rows_cuda as mr

SMALL = replace(DEEPSEEK_V2_LITE, hidden_size=64, moe_intermediate_size=32, n_routed_experts=8,
                num_experts_per_tok=2, experts_held=4, n_shared_experts=1)
WIDE_K = replace(SMALL, n_routed_experts=16, num_experts_per_tok=6, experts_held=4, first_expert=4)
T = 48


class _FormerDispatch(torch.autograd.Function):
    """The layer's dispatch before the row passes moved to ``moe_rows_cuda``."""

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


def _former_held_experts(layer, tokens, top_w, top_i):
    """``DeepSeekMoE._held_experts`` as the layer computed it before."""
    cfg = layer.cfg
    t, k = top_i.shape
    held, dev = cfg.experts_held, tokens.device
    local = top_i - cfg.first_expert
    mine = (local >= 0) & (local < held)
    key = torch.where(mine, local, held).reshape(-1)
    order = torch.argsort(key, stable=True)
    inv = torch.empty_like(order).scatter_(0, order, torch.arange(t * k, device=dev))
    counts = (key[:, None] == torch.arange(held, device=dev)).sum(dim=0)
    offs = torch.cumsum(counts, dim=0).to(torch.int32)
    dt = torch.get_autocast_dtype(dev.type) if torch.is_autocast_enabled(dev.type) else tokens.dtype
    xs = _FormerDispatch.apply(tokens.to(dt), order // k, inv, mine)
    gate, up = torch._grouped_mm(xs, layer.gate_up.to(dt), offs=offs).chunk(2, dim=-1)
    ys = torch._grouped_mm(F.silu(gate) * up, layer.down.to(dt), offs=offs)
    back = torch.where(mine[..., None], ys.index_select(0, inv).view(t, k, -1), 0)
    return torch.sum(back * top_w[..., None], dim=1)


def _routing(cfg, seed, held_share=None, t=T):
    """top_i (T, k): k distinct experts a token, drawn at random; with
    ``held_share``, each choice is a held expert with that probability
    (``1.0``: every choice held, ``0.0``: none).  Token 0 holds all k of
    its choices and token 1 none, where the layer holds k experts or more."""
    gen = torch.Generator().manual_seed(seed)
    e, k, held, first = cfg.n_routed_experts, cfg.num_experts_per_tok, cfg.experts_held, cfg.first_expert
    mine_ids = torch.arange(first, first + held)
    others = torch.tensor([i for i in range(e) if not first <= i < first + held], dtype=torch.long)
    rows = []
    for tok in range(t):
        if held_share is None:
            ids = torch.randperm(e, generator=gen)[:k]
        else:
            n_mine = int((torch.rand(k, generator=gen) < held_share).sum())
            if tok == 0 and held >= k:
                n_mine = k
            elif tok == 1 and len(others) >= k:
                n_mine = 0
            n_mine = max(min(n_mine, held), k - len(others))
            ids = torch.cat((mine_ids[torch.randperm(held, generator=gen)[:n_mine]],
                             others[torch.randperm(len(others), generator=gen)[:k - n_mine]]))
            ids = ids[torch.randperm(k, generator=gen)]
        rows.append(ids)
    return torch.stack(rows)


def _layer(cfg, seed=0):
    torch.manual_seed(seed)
    return DeepSeekMoE(cfg, 1)


def _inputs(cfg, seed, t=T):
    gen = torch.Generator().manual_seed(100 + seed)
    tokens = torch.randn(t, cfg.hidden_size, generator=gen)
    top_w = torch.rand(t, cfg.num_experts_per_tok, generator=gen)
    return tokens, top_w


CASES = [
    pytest.param(SMALL, None, False, id="small-f32"),
    pytest.param(SMALL, None, True, id="small-bf16"),
    pytest.param(WIDE_K, None, True, id="k6-bf16"),
    pytest.param(WIDE_K, 0.0, True, id="none-held"),
    pytest.param(replace(WIDE_K, experts_held=16, first_expert=0), 1.0, True, id="all-held"),
    pytest.param(WIDE_K, 0.5, False, id="half-held"),
]


@pytest.mark.parametrize("cfg,share,bf16", CASES)
def test_plain_versions_equal_the_former_chain(cfg, share, bf16):
    """On the CPU the layer's held-experts part (sort, gather, grouped
    products, SwiGLU, combine) gives the former chain's output and every
    gradient (tokens, router weights, both expert stacks) to the bit."""
    layer = _layer(cfg)
    top_i = _routing(cfg, 1, share)
    results = []
    for fn in (lambda *a: layer._held_experts(*a), lambda *a: _former_held_experts(layer, *a)):
        tokens, top_w = _inputs(cfg, 2)
        tokens.requires_grad_(True)
        top_w.requires_grad_(True)
        layer.zero_grad(set_to_none=True)
        with torch.autocast("cpu", dtype=torch.bfloat16, enabled=bf16):
            out = fn(tokens, top_w, top_i)
        torch.sin(out.float()).sum().backward()
        results.append([out, tokens.grad, top_w.grad, layer.gate_up.grad, layer.down.grad])
    for got, want in zip(*results):
        assert got.dtype == want.dtype and torch.equal(got, want)
    if share == 0.0:
        assert not results[0][0].any() and not results[0][3].any()


@pytest.mark.parametrize("seed", range(4))
def test_each_plain_version_equals_its_step_of_the_former_chain(seed):
    """gather_ref, swiglu_ref and combine_ref one by one against the
    former chain's step, forward and backward."""
    cfg = WIDE_K
    top_i = _routing(cfg, seed, 0.4)
    order, inv, counts, offs = mr.dispatch_plan(top_i, cfg.first_expert, cfg.experts_held)
    local = top_i - cfg.first_expert
    mine = (local >= 0) & (local < cfg.experts_held)
    k = cfg.num_experts_per_tok
    tokens, top_w = _inputs(cfg, seed)
    a, b = tokens.clone().requires_grad_(True), tokens.clone().requires_grad_(True)
    xs, former = mr.gather_ref(a, order, inv, offs, torch.bfloat16), _FormerDispatch.apply(
        b.to(torch.bfloat16), order // k, inv, mine)
    assert torch.equal(xs, former)
    g = torch.randn(xs.shape, generator=torch.Generator().manual_seed(seed)).to(torch.bfloat16)
    xs.backward(g)
    former.backward(g)
    assert torch.equal(a.grad, b.grad)

    h1 = torch.randn(T * k, 2 * cfg.moe_intermediate_size, dtype=torch.bfloat16, requires_grad=True)
    h = mr.swiglu_ref(h1)
    gate, up = h1.chunk(2, dim=-1)
    assert torch.equal(h, F.silu(gate) * up)

    ys = torch.randn(T * k, cfg.hidden_size).to(torch.bfloat16)
    back = torch.where(mine[..., None], ys.index_select(0, inv).view(T, k, -1), 0)
    assert torch.equal(mr.combine_ref(ys, top_w, inv, offs), torch.sum(back * top_w[..., None], dim=1))


@pytest.mark.parametrize("cfg,share", [(SMALL, None), (WIDE_K, None), (WIDE_K, 0.0), (WIDE_K, 0.7),
                                       (replace(WIDE_K, experts_held=16, first_expert=0), None)])
@pytest.mark.parametrize("seed", range(3))
def test_index_maps_match_the_plain_path(cfg, share, seed):
    """The kernels' index maps on random routings: row r < n holds choice
    (t, j) = divmod(order[r], k), whose row is r again (inv[t k + j] = r),
    whose expert is held, and whose gathered row is token t's; token t's
    rows are inv[t k + j], held exactly where its choice's expert is, and
    the held ones cover [0, n) once each."""
    k, held = cfg.num_experts_per_tok, cfg.experts_held
    top_i = _routing(cfg, seed, share)
    order, inv, counts, offs = mr.dispatch_plan(top_i, cfg.first_expert, held)
    n = int(offs[-1])
    local = top_i - cfg.first_expert
    mine = (local >= 0) & (local < held)
    assert n == int(mine.sum()) and torch.equal(counts, torch.bincount(local[mine], minlength=held))

    t_of, j_of = mr.row_sources(order, k)
    assert torch.equal(inv[t_of * k + j_of], torch.arange(T * k))
    assert mine[t_of[:n], j_of[:n]].all() and not mine[t_of[n:], j_of[n:]].any()
    tokens, _ = _inputs(cfg, seed)
    xs = mr.gather_ref(tokens, order, inv, offs, torch.float32)
    assert torch.equal(xs[:n], tokens[t_of[:n]])
    # each held row in its expert's group: the groups' ends are offs
    expert_of_row = local[t_of, j_of]
    starts = torch.cat((torch.zeros(1, dtype=torch.int32), offs[:-1]))
    for e in range(held):
        assert (expert_of_row[int(starts[e]):int(offs[e])] == e).all()

    rows, is_held = mr.token_rows(inv, offs, k)
    assert torch.equal(is_held, mine)
    assert torch.equal(rows[is_held].sort().values, torch.arange(n))
    assert (rows[~is_held] >= n).all()


def _ok_gather(**over):
    k, t, d = 6, 16, 64
    ops = dict(tokens=torch.zeros(t, d), order=torch.zeros(t * k, dtype=torch.int64),
               inv=torch.zeros(t * k, dtype=torch.int64), offs=torch.zeros(4, dtype=torch.int32),
               dtype=torch.bfloat16)
    ops.update(over)
    return ops


def _ok_combine(**over):
    k, t, d = 6, 16, 64
    ops = dict(ys=torch.zeros(t * k, d, dtype=torch.bfloat16), w=torch.zeros(t, k),
               inv=torch.zeros(t * k, dtype=torch.int64), offs=torch.zeros(4, dtype=torch.int32))
    ops.update(over)
    return ops


def test_operand_checks_accept_the_layers_operands():
    """The operands the layer hands over at the cell's widths (and in
    float32 rows, and a non-contiguous weight view) pass."""
    mr.check_operands("gather", **_ok_gather())
    mr.check_operands("gather", **_ok_gather(dtype=torch.float32))
    mr.check_operands("swiglu", h1=torch.zeros(96, 2 * 1408, dtype=torch.bfloat16),
                      offs=torch.zeros(8, dtype=torch.int32))
    mr.check_operands("combine", **_ok_combine())
    mr.check_operands("combine", **_ok_combine(w=torch.zeros(16, 7)[:, :6]))
    padded = torch.zeros(96, 2 * 1408 + 8, dtype=torch.bfloat16)[:, :2 * 1408]
    mr.check_operands("swiglu", h1=padded, offs=torch.zeros(8, dtype=torch.int32))


REFUSED = [
    ("gather", _ok_gather(tokens=torch.zeros(16, 64, dtype=torch.bfloat16)), TypeError),
    ("gather", _ok_gather(dtype=torch.float16), TypeError),
    ("gather", _ok_gather(tokens=torch.zeros(16, 60)), ValueError),
    ("gather", _ok_gather(tokens=torch.zeros(64, 16).t()), ValueError),
    ("gather", _ok_gather(order=torch.zeros(95, dtype=torch.int64)), ValueError),
    ("gather", _ok_gather(order=torch.zeros(96, dtype=torch.int32)), TypeError),
    ("gather", _ok_gather(inv=torch.zeros(96, 2, dtype=torch.int64)[:, 0]), TypeError),
    ("gather", _ok_gather(order=torch.zeros(16 * 9, dtype=torch.int64),
                          inv=torch.zeros(16 * 9, dtype=torch.int64)), ValueError),
    ("gather", _ok_gather(offs=torch.zeros(4, dtype=torch.int64)), TypeError),
    ("gather", _ok_gather(offs=torch.zeros(0, dtype=torch.int32)), TypeError),
    ("gather", _ok_gather(offs=torch.zeros(4, 2, dtype=torch.int32)[:, 0]), TypeError),
    ("gather", _ok_gather(tokens=torch.zeros(16 * 64 + 1)[1:].view(16, 64)), ValueError),
    ("gather", _ok_gather(offs=torch.zeros(4, dtype=torch.int32, device="meta")), ValueError),
    ("swiglu", dict(h1=torch.zeros(96, 2 * 12, dtype=torch.bfloat16),
                    offs=torch.zeros(8, dtype=torch.int32)), ValueError),
    ("swiglu", dict(h1=torch.zeros(96, 32, dtype=torch.float16),
                    offs=torch.zeros(8, dtype=torch.int32)), TypeError),
    ("swiglu", dict(h1=torch.zeros(96, 32, 2, dtype=torch.bfloat16)[..., 0],
                    offs=torch.zeros(8, dtype=torch.int32)), ValueError),
    ("combine", _ok_combine(w=torch.zeros(16, 6, dtype=torch.bfloat16)), TypeError),
    ("combine", _ok_combine(ys=torch.zeros(96, 64, dtype=torch.float64)), TypeError),
    ("combine", _ok_combine(w=torch.zeros(16, 5)), ValueError),
    ("combine", _ok_combine(inv=torch.zeros(95, dtype=torch.int64)), ValueError),
    ("combine", _ok_combine(ys=torch.zeros(96, 20, dtype=torch.bfloat16)), ValueError),
    ("combine", _ok_combine(ys=torch.zeros(9 * 16, 64, dtype=torch.bfloat16), w=torch.zeros(16, 9),
                            inv=torch.zeros(9 * 16, dtype=torch.int64)), ValueError),
    ("mlp", _ok_combine(), ValueError),
]


@pytest.mark.parametrize("kind,ops,error", REFUSED, ids=[f"{k}-{i}" for i, (k, _, _) in enumerate(REFUSED)])
def test_operand_checks_refuse_what_the_kernels_cannot_take(kind, ops, error):
    """float16 rows or bf16 tokens, widths off a multiple of 8, transposed
    or misaligned rows, index vectors of the wrong length, dtype or layout,
    more than MAX_K choices, offs not int32 or empty or strided, operands on
    two devices, an unknown pass: each raises."""
    with pytest.raises(error):
        mr.check_operands(kind, **ops)


def test_wrappers_take_the_plain_versions_on_the_cpu_and_refuse_other_devices():
    cfg = WIDE_K
    top_i = _routing(cfg, 5, 0.5)
    order, inv, _, offs = mr.dispatch_plan(top_i, cfg.first_expert, cfg.experts_held)
    tokens, top_w = _inputs(cfg, 5)
    assert torch.equal(mr.gather(tokens, order, inv, offs, torch.bfloat16),
                       mr.gather_ref(tokens, order, inv, offs, torch.bfloat16))
    h1 = torch.randn(T * 6, 64)
    assert torch.equal(mr.swiglu(h1, offs), mr.swiglu_ref(h1))
    ys = torch.randn(T * 6, cfg.hidden_size)
    assert torch.equal(mr.combine(ys, top_w, inv, offs), mr.combine_ref(ys, top_w, inv, offs))
    with pytest.raises(ValueError):
        mr.swiglu(torch.zeros(4, 16, device="meta"), offs)


def test_dispatch_plan_is_the_layers_sort():
    """The plan's sort is stable: within an expert's group the rows keep
    the choices' order, and the choices not held follow in theirs."""
    cfg = WIDE_K
    top_i = _routing(cfg, 9, 0.5)
    order, inv, counts, offs = mr.dispatch_plan(top_i, cfg.first_expert, cfg.experts_held)
    local = (top_i - cfg.first_expert).reshape(-1)
    key = torch.where((local >= 0) & (local < cfg.experts_held), local, cfg.experts_held)
    want = np.argsort(key.numpy(), kind="stable")
    assert torch.equal(order, torch.from_numpy(want)) and torch.equal(order[inv], torch.arange(order.numel()))
    assert int(offs[-1]) == int(counts.sum()) and offs.dtype == torch.int32
