"""PlaneNet's DeepSeek-V2 trunk (``models/deepseek_v2.py``) against the plain
reference ``benchmark/reference/dsv2.py`` on seeded weights, on the CPU at a
small size: d 64, 4 heads, MLA rank 32 / nope 16 / rope 8 / v 16, 8
experts top 2 of which 4 are held, 1 dense + 2 MoE layers.  The program runs
in float32, the reference in float64 (or float32 where the routing is held
to it exactly)."""
import math
import os
import sys
from dataclasses import asdict, replace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import weights as wts  # noqa: E402
from benchmark.reference import dsv2 as ref  # noqa: E402
from benchmark.reference import processes as ref_proc  # noqa: E402
from benchmark.reference.schedule import Schedule  # noqa: E402
from diffusion_extensions_tpu_torch import obs  # noqa: E402
from diffusion_extensions_tpu_torch.experiments import aircraft  # noqa: E402
from diffusion_extensions_tpu_torch.flops import dsv2_planenet_flops  # noqa: E402
from diffusion_extensions_tpu_torch.models.deepseek_v2 import (  # noqa: E402
    DEEPSEEK_V2_LITE, MLA, TRUNKS, DeepSeekMoE, SwiGLU)
from diffusion_extensions_tpu_torch.models.planenet import PlaneNet  # noqa: E402
from diffusion_extensions_tpu_torch.processes.so3 import ProjectedSO3Diffusion  # noqa: E402

SMALL = replace(DEEPSEEK_V2_LITE, hidden_size=64, num_attention_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
                qk_rope_head_dim=8, v_head_dim=16, intermediate_size=96, moe_intermediate_size=32,
                n_routed_experts=8, num_experts_per_tok=2, num_hidden_layers=3, experts_held=4)
B, N = 4, 16


def _ref_cfg(c) -> dict:
    return dict(asdict(c), rope_scaling={"factor": c.rope_factor, "mscale_all_dim": c.mscale_all_dim})


def _weights(c=SMALL, seed=3) -> dict:
    return wts.make(ref.param_spec(_ref_cfg(c)), seed, torch.device("cpu"))


def _f64(w: dict) -> dict:
    return {k: v.double() for k, v in w.items()}


def _sub(w: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in w.items() if k.startswith(prefix)}


def _x(seed=0, shape=(B, N, SMALL.hidden_size)) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _model(c=SMALL, seed=3) -> PlaneNet:
    model = PlaneNet(trunk=c)
    model.load_state_dict(_weights(c, seed), strict=True)
    return model


def _moe(c, index=1, seed=3) -> DeepSeekMoE:
    layer = DeepSeekMoE(c, index)
    layer.load_state_dict(_sub(_weights(c, seed), f"encoder.layers.{index}.mlp."), strict=True)
    return layer


def _close(got, want, rel=2e-5):
    assert float((got.double() - want).abs().max()) <= rel * float(want.abs().max())


def test_spec_is_the_programs_layout():
    assert {k: tuple(v.shape) for k, v in PlaneNet(trunk=SMALL).state_dict().items()} == {
        k: tuple(v.shape) for k, v in _weights().items()}


def test_published_trunk_is_the_catalogs():
    """The preset the driver names: DeepSeek-V2-Lite's widths, 1 dense + 4
    MoE layers, 8 of 64 experts, and YaRN's softmax scale."""
    c = TRUNKS["dsv2lite-ep8"]
    assert (c.hidden_size, c.num_attention_heads, c.kv_lora_rank, c.qk_nope_head_dim, c.qk_rope_head_dim,
            c.v_head_dim) == (2048, 16, 512, 128, 64, 128)
    assert (c.intermediate_size, c.moe_intermediate_size, c.n_routed_experts, c.num_experts_per_tok,
            c.n_shared_experts, c.first_k_dense_replace) == (10944, 1408, 64, 6, 2, 1)
    assert (c.num_hidden_layers, c.experts_held, c.first_expert) == (5, 8, 0)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert c.softmax_scale == pytest.approx(192 ** -0.5 * m * m, rel=1e-12)


def test_mla_matches_reference():
    w = _weights()
    layer = MLA(SMALL)
    layer.load_state_dict(_sub(w, "encoder.layers.0.self_attn."), strict=True)
    x = _x()
    with torch.no_grad():
        got = layer(x)
    want = ref.mla(_f64(w), "encoder.layers.0.self_attn", x.double(), ref._cfg(_ref_cfg(SMALL)))
    _close(got, want)


def test_dense_ffn_matches_reference():
    w = _weights()
    layer = SwiGLU(SMALL.hidden_size, SMALL.intermediate_size)
    layer.load_state_dict(_sub(w, "encoder.layers.0.mlp."), strict=True)
    x = _x(1)
    with torch.no_grad():
        got = layer(x)
    _close(got, ref.swiglu(_f64(w), "encoder.layers.0.mlp", x.double()))


def test_routing_is_the_references_exactly():
    """Float32 on both sides: the same top-k experts, in the same order,
    and the same scores."""
    layer, w = _moe(SMALL), _weights()
    tokens = _x(2).reshape(-1, SMALL.hidden_size)
    with torch.no_grad():
        probs, top_w, top_i = layer.route(tokens)
    r_probs, r_w, r_i = ref.route(w, "encoder.layers.1.mlp", tokens, ref._cfg(_ref_cfg(SMALL)))
    assert torch.equal(top_i, r_i)
    torch.testing.assert_close(top_w, r_w, rtol=1e-6, atol=0)
    torch.testing.assert_close(probs, r_probs, rtol=1e-6, atol=0)


def test_routing_takes_the_top_k_unrenormalised():
    layer = _moe(SMALL)
    tokens = _x(3).reshape(-1, SMALL.hidden_size)
    with torch.no_grad():
        probs, top_w, top_i = layer.route(tokens)
    order = probs.argsort(-1, descending=True)[:, :SMALL.num_experts_per_tok]
    assert torch.equal(top_i, order)
    assert torch.equal(top_w, probs.gather(-1, top_i))
    assert float(top_w.sum(-1).max()) < 1.0


@pytest.mark.parametrize("held,first", [(4, 0), (4, 4), (8, 0), (2, 6)])
def test_moe_layer_matches_reference(held, first):
    c = replace(SMALL, experts_held=held, first_expert=first)
    layer, w = _moe(c), _weights(c)
    x = _x(4)
    with torch.no_grad():
        got = layer(x)
    want, aux = ref.moe(_f64(w), "encoder.layers.1.mlp", x.double(), ref._cfg(_ref_cfg(c)))
    _close(got, want)
    assert float(layer.aux_loss) == pytest.approx(float(aux), rel=1e-5)


def test_balance_loss_counts_per_cloud():
    """f_bi = E / (k N) #{t in b: i chosen}, P_bi = mean_t s_ti, the loss
    mean_b sum_i f_bi P_bi, written out with numpy."""
    layer = _moe(SMALL)
    x = _x(5)
    with torch.no_grad():
        layer(x)
        probs, _, top_i = layer.route(x.reshape(-1, SMALL.hidden_size))
    e, k = SMALL.n_routed_experts, SMALL.num_experts_per_tok
    p, idx = probs.numpy().reshape(B, N, e), top_i.numpy().reshape(B, N, k)
    total = 0.0
    for b in range(B):
        f = np.bincount(idx[b].ravel(), minlength=e) * e / (k * N)
        total += (f * p[b].mean(0)).sum()
    assert float(layer.aux_loss) == pytest.approx(total / B, rel=1e-6)
    np.testing.assert_allclose(layer.expert_frac.numpy(), np.bincount(idx.ravel(), minlength=e) / idx.size)


def test_shares_add_up_to_the_uncut_layer():
    """Each of the E / held ranks' layers computes its own experts' part;
    the parts, with the shared experts counted once, add up to the uncut
    reference layer (all experts held)."""
    held = SMALL.experts_held
    x = _x(6)
    full = replace(SMALL, experts_held=SMALL.n_routed_experts)
    fw = _weights(full)
    want, _ = ref.moe(_f64(fw), "encoder.layers.1.mlp", x.double(), ref._cfg(_ref_cfg(full)))
    total, shared = 0.0, None
    for r in range(SMALL.n_routed_experts // held):
        c = replace(SMALL, first_expert=r * held)
        layer = DeepSeekMoE(c, 1)
        w = _sub(fw, "encoder.layers.1.mlp.")
        w = dict(w, gate_up=w["gate_up"][r * held:(r + 1) * held], down=w["down"][r * held:(r + 1) * held])
        layer.load_state_dict(w, strict=True)
        with torch.no_grad():
            out = layer(x).double()
            shared = layer.shared_experts(x).double()
        total = total + out - shared
    got = total + shared
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def _batch(seed=7):
    rng = np.random.default_rng(seed)
    clouds = torch.from_numpy(rng.standard_normal((B, N, 3)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 50, B))
    q, _ = np.linalg.qr(rng.standard_normal((B, 3, 3)))
    noise = torch.from_numpy((q * np.linalg.det(q)[:, None, None]).astype(np.float32))
    return clouds, t, noise


def test_denoiser_forward_matches_reference():
    w = _weights()
    model = _model()
    clouds, t, _ = _batch()
    with torch.no_grad():
        got = model(clouds, t)
    want, aux = ref.forward(_f64(w), _ref_cfg(SMALL), clouds.double(), t)
    _close(got, want, 5e-5)
    assert float(model.moe_aux()) == pytest.approx(float(aux), rel=1e-5)


def test_loss_and_every_gradient_match_reference():
    """The driver's loss (with the balance loss at aux_loss_alpha) and the
    gradient of every leaf, from the same t and noise."""
    w = _weights()
    model = _model()
    process = ProjectedSO3Diffusion(timesteps=50, device=torch.device("cpu"))
    clouds, t, noise = _batch()
    loss = aircraft.make_loss_fn(model, process)(None, (clouds, t, noise))
    loss.backward()
    p = {k: v.requires_grad_(True) for k, v in _f64(w).items()}
    aux = []

    def net(x, tt):
        out, a = ref.forward(p, _ref_cfg(SMALL), x, tt)
        aux.append(a)
        return out

    base = ref_proc.so3_loss(net, clouds.double(), t, noise.double(), Schedule(50, torch.device("cpu")))
    want = base + SMALL.aux_loss_alpha * aux[0]
    assert float(loss.detach()) == pytest.approx(float(want.detach()), rel=1e-5)
    grads = dict(zip(p, torch.autograd.grad(want, list(p.values()))))
    # a leaf small by cancellation (the pool gate's bias) keeps the float32
    # rounding of the terms that cancel: 1e-6 of the median leaf's norm
    floor = 1e-6 * float(np.median([float(g.norm()) for g in grads.values()]))
    for name, param in model.named_parameters():
        g, r = param.grad.double(), grads[name]
        assert float((g - r).norm()) <= 1e-4 * float(r.norm()) + floor, name


_SYNCS = {"nonzero", "_local_scalar_dense", "masked_select", "masked_scatter", "bincount", "unique_dim",
          "_unique2", "unique_consecutive", "item", "repeat_interleave"}


class _Watch(TorchDispatchMode):
    """The ops a block runs whose result shape depends on the data or that
    read a value on the host; and boolean indexing."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in _SYNCS:
            self.found.append(name)
        if name in ("index", "index_put", "index_put_"):
            index = args[1] if len(args) > 1 else []
            if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in index):
                self.found.append(name + " by a mask")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("bf16", [False, True])
def test_dispatch_waits_for_no_value(bf16):
    """The MoE layer's forward and backward (router, dispatch, grouped
    products, combine, balance loss, device counters) call no
    ``nonzero``, no boolean indexing and nothing that reads a value on the
    host: what a CUDA graph capture needs."""
    layer = _moe(SMALL)
    x = _x(8).requires_grad_(True)
    watch = _Watch()
    with watch, torch.autocast("cpu", dtype=torch.bfloat16, enabled=bf16):
        out = layer(x)
        (out.float().square().mean() + layer.aux_loss).backward()
    assert watch.found == [], watch.found
    assert x.grad is not None and all(p.grad is not None for p in layer.parameters())


def test_dispatch_sums_a_tokens_rows_without_atomics():
    """Each token's rows come back in the fixed order of its choices: two
    backward passes give the same bits, and the input gradient is that of
    a plain loop over the held experts."""
    layer = _moe(SMALL)
    x = _x(9)
    grads = []
    for _ in range(2):
        xx = x.clone().requires_grad_(True)
        layer(xx).square().sum().backward()
        grads.append(xx.grad)
    assert torch.equal(grads[0], grads[1])
    w = _f64(_weights())
    xd = x.double().requires_grad_(True)
    out, _ = ref.moe(w, "encoder.layers.1.mlp", xd, ref._cfg(_ref_cfg(SMALL)))
    out.square().sum().backward()
    _close(grads[0], xd.grad, 1e-4)


def test_device_counters_count_the_held_rows():
    obs.reset()
    layer = _moe(SMALL)
    x = _x(10)
    with torch.no_grad():
        layer(x)
        layer(x)
        _, _, top_i = layer.route(x.reshape(-1, SMALL.hidden_size))
    counts = torch.bincount(top_i.reshape(-1), minlength=SMALL.n_routed_experts)[:SMALL.experts_held]
    c = obs.snapshot()["counters"]
    assert c["moe.rows"] == 2 * int(counts.sum()) and c["moe.rows_max"] == 2 * int(counts.max())
    assert c["moe.layer_steps"] == 2 and c["moe.experts_held"] == 2 * SMALL.experts_held
    obs.reset()
    assert "moe.rows" not in obs.snapshot()["counters"]


def test_closed_form_flops_are_flopcountermodes_plus_the_grouped_rows():
    """FlopCounterMode counts every product of a forward but the grouped
    ones (``torch._grouped_mm`` has no formula there); the closed form adds
    them at the expected rows, T k held / E a layer, and at the rows the
    forward routed it is FlopCounterMode's count plus theirs exactly."""
    model = _model()
    clouds, t, _ = _batch()
    obs.reset()
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(clouds, t)
    rows = obs.snapshot()["counters"]["moe.rows"]
    obs.reset()
    moe_layers = SMALL.num_hidden_layers - SMALL.first_k_dense_replace
    per_row = 2 * 3 * SMALL.hidden_size * SMALL.moe_intermediate_size
    expected = moe_layers * B * N * SMALL.num_experts_per_tok * SMALL.experts_held / SMALL.n_routed_experts
    assert counter.get_total_flops() + per_row * rows == dsv2_planenet_flops(SMALL, B, N) + per_row * (
        rows - expected)


def test_trunk_refuses_a_switch_moe():
    with pytest.raises(ValueError):
        PlaneNet(trunk=SMALL, moe_experts=4)


def test_driver_trains_the_trunk(tmp_path, monkeypatch):
    """``--trunk`` through the aircraft driver's train() and --test: K = 2
    steps a call, the loss finite, the checkpoint the trunk's layout."""
    monkeypatch.setitem(aircraft.TRUNKS, "small", SMALL)
    ckpt = str(tmp_path / "ck")
    flags = ["--so3", "--device", "cpu", "--trunk", "small", "--batch", "4", "--samples", "16", "--timesteps",
             "20", "--data-root", "/nonexistent", "--ckpt", ckpt, "--no-native"]
    state = aircraft.main(flags + ["--steps", "4", "--steps-per-call", "2", "--print-every", "2"])
    assert state.step == 4
    names = dict(state.model.named_parameters())
    assert "encoder.layers.1.mlp.gate_up" in names and names["encoder.layers.1.mlp.gate_up"].shape[0] == 4
    assert isinstance(state.model.encoder.layers[2].mlp, DeepSeekMoE)
    monkeypatch.setattr(aircraft, "SAMPLES_PER_SHAPE", 1)
    res = aircraft.main(flags + ["--test", "--max-shapes", "4"])
    assert np.isfinite(res).all()
