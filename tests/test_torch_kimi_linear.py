"""PlaneNet's Kimi Linear trunk (``models/kimi_linear.py``) against the plain
reference ``benchmark/reference/kimi_linear.py`` on seeded weights, on the
CPU at a small size: d 64, KDA 2 heads of 16, MLA 4 heads of rank 32 /
nope 16 / rope 8 / v 16, 16 experts top 4 of which 8 are held, the
published layers 1-5 (KDA + dense, KDA, KDA, MLA, KDA), chunks of 8.  The
chunked recurrence is held to the token-by-token one in float64; the
program otherwise runs in float32, the reference in float64."""
import os
import sys
from dataclasses import replace

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import weights as wts  # noqa: E402
from benchmark.reference import kimi_linear as ref  # noqa: E402
from benchmark.reference import processes as ref_proc  # noqa: E402
from benchmark.reference.schedule import Schedule  # noqa: E402
from diffusion_extensions_tpu_torch import obs  # noqa: E402
from diffusion_extensions_tpu_torch.experiments import aircraft  # noqa: E402
from diffusion_extensions_tpu_torch.flops import kimi_planenet_flops  # noqa: E402
from diffusion_extensions_tpu_torch.models import kimi_linear  # noqa: E402
from diffusion_extensions_tpu_torch.models.deepseek_v2 import DeepSeekMoE  # noqa: E402
from diffusion_extensions_tpu_torch.models.kimi_linear import (  # noqa: E402
    KIMI_LINEAR_48B, TRUNKS, KimiDeltaAttention, chunk_kda)
from diffusion_extensions_tpu_torch.models.planenet import PlaneNet  # noqa: E402
from diffusion_extensions_tpu_torch.parallel.dp import make_dp_train_step  # noqa: E402
from diffusion_extensions_tpu_torch.processes.so3 import ProjectedSO3Diffusion  # noqa: E402
from diffusion_extensions_tpu_torch.train.optim import make_optimizer  # noqa: E402
from diffusion_extensions_tpu_torch.train.state import TrainState, restore_checkpoint, save_checkpoint  # noqa: E402

SMALL = replace(KIMI_LINEAR_48B, hidden_size=64, intermediate_size=96, moe_intermediate_size=32, num_experts=16,
                num_experts_per_token=4, num_attention_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
                qk_rope_head_dim=8, v_head_dim=16, linear_attn_num_heads=2, linear_attn_head_dim=16,
                num_hidden_layers=5, experts_held=8, chunk_size=8)
B, N = 3, 20
CPU = torch.device("cpu")


def _ref_cfg(c=SMALL) -> dict:
    return dict(hidden_size=c.hidden_size, num_attention_heads=c.num_attention_heads,
                qk_nope_head_dim=c.qk_nope_head_dim, qk_rope_head_dim=c.qk_rope_head_dim, v_head_dim=c.v_head_dim,
                kv_lora_rank=c.kv_lora_rank, intermediate_size=c.intermediate_size,
                moe_intermediate_size=c.moe_intermediate_size, num_experts=c.num_experts,
                num_experts_per_token=c.num_experts_per_token, num_shared_experts=c.num_shared_experts,
                first_k_dense_replace=c.first_k_dense_replace, num_hidden_layers=c.num_hidden_layers,
                rms_norm_eps=c.rms_norm_eps, routed_scaling_factor=c.routed_scaling_factor,
                experts_held=c.experts_held, first_expert=c.first_expert, bias_update_speed=c.bias_update_speed,
                linear_attn_config=dict(num_heads=c.linear_attn_num_heads, head_dim=c.linear_attn_head_dim,
                                        short_conv_kernel_size=c.short_conv_kernel_size,
                                        kda_layers=list(c.kda_layers), full_attn_layers=list(c.full_attn_layers)))


def _weights(c=SMALL, seed=3) -> dict:
    return wts.make(ref.param_spec(_ref_cfg(c)), seed, CPU)


def _f64(w: dict) -> dict:
    return {k: v.double() for k, v in w.items()}


def _sub(w: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in w.items() if k.startswith(prefix)}


def _model(c=SMALL, seed=3) -> PlaneNet:
    model = PlaneNet(trunk=c)
    buffers = {k: torch.zeros_like(v) for k, v in model.named_buffers()}
    model.load_state_dict(dict(_weights(c, seed), **buffers), strict=True)
    return model


def _moe(c=SMALL, index=1, seed=3) -> DeepSeekMoE:
    layer = DeepSeekMoE(c.deepseek(), index)
    w = _sub(_weights(c, seed), f"encoder.layers.{index}.mlp.")
    layer.load_state_dict(dict(w, e_score_correction_bias=torch.zeros(c.num_experts)), strict=True)
    return layer


def _x(seed=0, shape=(B, N, SMALL.hidden_size)) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _close(got, want, rel=2e-5):
    assert float((got.double() - want).abs().max()) <= rel * float(want.abs().max())


def _kda_inputs(n, seed=0, decay=0.3, b=2, h=3, dk=8, dv=6):
    gen = torch.Generator().manual_seed(seed)
    q = torch.nn.functional.normalize(torch.randn(b, h, n, dk, generator=gen, dtype=torch.float64), dim=-1)
    k = torch.nn.functional.normalize(torch.randn(b, h, n, dk, generator=gen, dtype=torch.float64), dim=-1)
    v = torch.randn(b, h, n, dv, generator=gen, dtype=torch.float64)
    g = -torch.rand(b, h, n, dk, generator=gen, dtype=torch.float64) * decay
    beta = torch.rand(b, h, n, generator=gen, dtype=torch.float64)
    return [x.requires_grad_(True) for x in (q * dk ** -0.5, k, v, g, beta)]


def _with_grads(fn, xs, seed=1):
    out = fn(*xs)
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed), dtype=out.dtype)
    return out.detach(), torch.autograd.grad((out * w).sum(), xs)


@pytest.mark.parametrize("n", [16, 32, 48, 80, 37])
def test_chunked_kda_is_the_token_recurrence(n):
    """Chunks of 16 over 1, 2, 3 and 5 chunks (and a ragged 37): the output
    and the gradient of every input equal the recurrence's in float64."""
    xs = _kda_inputs(n)
    got, got_g = _with_grads(lambda *a: kimi_linear._chunks(*a, 16), xs)
    want, want_g = _with_grads(lambda *a: ref.recurrent_kda(*a, segment=7), xs)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-13)
    for a, b in zip(got_g, want_g):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)


@pytest.mark.parametrize("n,carried", [(16, True), (48, False)])
def test_chunks_carry_the_state(n, carried, monkeypatch):
    """A state not carried across chunks leaves one chunk right and parts
    from the recurrence over several: the test above would catch it."""
    monkeypatch.setattr(kimi_linear, "_carry", lambda M, R: torch.zeros_like(R))
    xs = _kda_inputs(n, decay=0.05)
    got = kimi_linear._chunks(*xs, 16)
    want = ref.recurrent_kda(*xs)
    assert torch.allclose(got, want, rtol=0, atol=1e-12) == carried


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_strongly_decaying_gates_stay_finite(dtype, atol):
    """Log-decays of -1e3 .. -2e4 a point (A_log ~ 7 .. 10): every exp the
    chunks take is of a non-positive argument, so nothing overflows; the
    output and gradients are finite and the recurrence's (the program's
    float32, and the chunks' arithmetic in float64)."""
    q, k, v, _, beta = _kda_inputs(64)
    g = -torch.exp(torch.empty(2, 3, 64, 8, dtype=torch.float64).uniform_(7, 10, generator=torch.Generator()))
    xs = [x.detach().to(dtype).requires_grad_(True) for x in (q, k, v, g, beta)]
    fn = chunk_kda if dtype == torch.float32 else kimi_linear._chunks
    got, got_g = _with_grads(lambda *a: fn(*a, 16), xs)
    assert got.dtype == dtype
    assert torch.isfinite(got).all() and all(torch.isfinite(x).all() for x in got_g)
    want = ref.recurrent_kda(*[x.detach().double() for x in xs])
    torch.testing.assert_close(got.double(), want, rtol=0, atol=atol)


def test_chunk_kda_float32_follows_float64():
    xs = _kda_inputs(80, seed=4)
    want = kimi_linear._chunks(*xs, 16)
    got = chunk_kda(*[x.detach().float() for x in xs], chunk=16)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.double(), want.detach(), rtol=0, atol=1e-5)


def test_spec_is_the_programs_layout():
    assert {k: tuple(v.shape) for k, v in PlaneNet(trunk=SMALL).named_parameters()} == {
        k: tuple(v.shape) for k, v in _weights().items()}
    assert sorted(n for n, _ in PlaneNet(trunk=SMALL).named_buffers()) == [
        f"encoder.layers.{i}.mlp.e_score_correction_bias" for i in range(1, 5)]


def test_published_trunk_is_the_catalogs():
    """The preset the driver names: Kimi-Linear-48B-A3B's widths, the
    published layers 1-5 (MLA the fourth), 8 of 256 experts."""
    c = TRUNKS["kimilinear-ep32"]
    assert (c.hidden_size, c.intermediate_size, c.moe_intermediate_size, c.num_experts, c.num_experts_per_token,
            c.num_shared_experts, c.routed_scaling_factor, c.rms_norm_eps) == (2304, 9216, 1024, 256, 8, 1, 2.446,
                                                                                1e-5)
    assert (c.num_attention_heads, c.kv_lora_rank, c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim) == (
        32, 512, 128, 64, 128)
    assert (c.linear_attn_num_heads, c.linear_attn_head_dim, c.short_conv_kernel_size) == (32, 128, 4)
    assert [c.is_kda(i) for i in range(c.num_hidden_layers)] == [True, True, True, False, True]
    assert (c.num_hidden_layers, c.experts_held, c.first_expert, c.aux_loss_alpha) == (5, 8, 0, 0.0)
    assert c.deepseek().softmax_scale == pytest.approx(192 ** -0.5, rel=1e-12)
    with torch.device("meta"):
        model = PlaneNet(trunk=c)
    counts = {type(m).__name__: sum(p.numel() for p in m.parameters()) for m in (
        model.encoder.layers[0].self_attn, model.encoder.layers[3].self_attn, model.encoder.layers[0].mlp,
        model.encoder.layers[1].mlp)}
    assert counts == {"KimiDeltaAttention": 39_518_368, "MLA": 29_114_880, "SwiGLU": 63_700_992,
                      "DeepSeekMoE": 64_290_816}


def test_kda_layer_matches_reference():
    w = _weights()
    layer = KimiDeltaAttention(SMALL, 0)
    layer.load_state_dict(_sub(w, "encoder.layers.0.self_attn."), strict=True)
    x = _x(1)
    with torch.no_grad():
        got = layer(x)
    want = ref.kda(_f64(w), "encoder.layers.0.self_attn", x.double(), ref._cfg(_ref_cfg()))
    _close(got, want)


def test_routing_selects_by_score_plus_bias_and_renormalises():
    """Float32 on both sides, a non-zero correction bias: the reference's
    experts in its order, weights 2.446 s_i / sum of the chosen s."""
    layer, w = _moe(), _weights()
    bias = torch.linspace(-0.05, 0.05, SMALL.num_experts)
    layer.e_score_correction_bias.copy_(bias)
    tokens = _x(2).reshape(-1, SMALL.hidden_size)
    with torch.no_grad():
        scores, top_w, top_i = layer.route(tokens)
    r_w, r_i = ref.route(w, "encoder.layers.1.mlp", tokens, bias, ref._cfg(_ref_cfg()))
    assert torch.equal(top_i, r_i)
    torch.testing.assert_close(top_w, r_w, rtol=1e-6, atol=0)
    assert torch.equal(top_i, (scores + bias).argsort(-1, descending=True)[:, :SMALL.num_experts_per_token])
    torch.testing.assert_close(top_w.sum(-1), torch.full((tokens.shape[0],), 2.446), rtol=1e-6, atol=0)
    assert not torch.equal(top_i, scores.argsort(-1, descending=True)[:, :SMALL.num_experts_per_token])


@pytest.mark.parametrize("held,first", [(8, 0), (8, 8), (4, 12)])
def test_moe_layer_matches_reference(held, first):
    c = replace(SMALL, experts_held=held, first_expert=first)
    layer, w = _moe(c), _weights(c)
    x = _x(4)
    with torch.no_grad():
        got = layer(x)
    want, counts = ref.moe(_f64(w), "encoder.layers.1.mlp", x.double(), torch.zeros(16), ref._cfg(_ref_cfg(c)))
    _close(got, want)
    assert torch.equal(layer.choice_counts, counts)
    assert layer.aux_loss is None


def test_bias_moves_by_the_sign_rule_over_three_steps():
    """Three forwards, each followed by ``after_step``: b_i += 0.001
    sign(mean - c_i), as numpy writes it, and as the reference's
    ``update_bias`` does."""
    layer = _moe()
    want, ref_bias = np.zeros(16, np.float32), torch.zeros(16)
    for step in range(3):
        with torch.no_grad():
            layer(_x(10 + step))
        counts = layer.choice_counts.numpy()
        assert counts.sum() == B * N * SMALL.num_experts_per_token
        want = want + np.float32(0.001) * np.sign(counts.mean() - counts).astype(np.float32)
        ref_bias = ref.update_bias(ref_bias, layer.choice_counts, ref._cfg(_ref_cfg()))
        layer.after_step()
        np.testing.assert_array_equal(layer.e_score_correction_bias.numpy(), want)
        assert torch.equal(layer.e_score_correction_bias, ref_bias)
    assert np.abs(want).max() > 0


def test_train_step_moves_the_bias_once_an_optimizer_step(monkeypatch):
    """Through ``make_dp_train_step`` (K = 3 eager sub-steps on the CPU):
    each layer's bias moves once a step, by the last forward's choices."""
    moves = []
    orig = DeepSeekMoE.after_step

    def spy(self, groups=()):
        before = self.e_score_correction_bias.clone()
        orig(self, groups)
        moves.append((self.span, self.e_score_correction_bias - before, self.choice_counts.clone()))

    monkeypatch.setattr(DeepSeekMoE, "after_step", spy)
    model = _model()
    process = ProjectedSO3Diffusion(timesteps=20, device=CPU)
    opt = make_optimizer(model.named_parameters(), 1e-3)
    step = make_dp_train_step(aircraft.make_loss_fn(model, process), model, opt, steps_per_call=3)
    state = TrainState(model, opt, torch.Generator().manual_seed(0))
    step(state, torch.randn(3, 4, N, 3, generator=torch.Generator().manual_seed(1)))
    assert [m[0] for m in moves] == [f"moe.l{i}" for i in range(1, 5)] * 3
    for _, move, counts in moves:
        torch.testing.assert_close(move, 0.001 * torch.sign(counts.float().mean() - counts.float()))


def test_shares_add_up_to_the_uncut_layer():
    """At E = 16 over 4 ranks of 4 held experts: the ranks' parts, with the
    shared expert counted once, add up to the uncut reference layer."""
    x = _x(6)
    full = replace(SMALL, experts_held=16)
    fw = _weights(full)
    bias = torch.linspace(0.02, -0.02, 16)
    want, _ = ref.moe(_f64(fw), "encoder.layers.1.mlp", x.double(), bias, ref._cfg(_ref_cfg(full)))
    total, shared = 0.0, None
    for r in range(4):
        layer = DeepSeekMoE(replace(SMALL, experts_held=4, first_expert=4 * r).deepseek(), 1)
        w = _sub(fw, "encoder.layers.1.mlp.")
        w = dict(w, gate_up=w["gate_up"][4 * r:4 * r + 4], down=w["down"][4 * r:4 * r + 4],
                 e_score_correction_bias=bias)
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


def test_loss_and_every_gradient_match_reference():
    """The driver's loss (no balance loss) and the gradient of every leaf,
    from the same t and noise, with non-zero correction biases."""
    w = _weights()
    model = _model()
    biases = [torch.linspace(-0.01, 0.01, 16) * (i + 1) for i in range(4)]
    for m, b in zip(model.encoder.moe_layers(), biases):
        m.e_score_correction_bias.copy_(b)
    process = ProjectedSO3Diffusion(timesteps=50, device=CPU)
    clouds, t, noise = _batch()
    loss = aircraft.make_loss_fn(model, process)(None, (clouds, t, noise))
    loss.backward()
    p = {k: v.requires_grad_(True) for k, v in _f64(w).items()}
    want = ref_proc.so3_loss(lambda x, tt: ref.forward(p, _ref_cfg(), x, tt, biases)[0], clouds.double(), t,
                             noise.double(), Schedule(50, CPU))
    assert float(loss.detach()) == pytest.approx(float(want.detach()), rel=1e-5)
    grads = dict(zip(p, torch.autograd.grad(want, list(p.values()))))
    floor = 1e-6 * float(np.median([float(g.norm()) for g in grads.values()]))
    for name, param in model.named_parameters():
        g, r = param.grad.double(), grads[name]
        assert float((g - r).norm()) <= 1e-4 * float(r.norm()) + floor, name


def test_kda_forward_and_backward_wait_for_no_value():
    """KDA's mixer (projections, convolutions, gates, the chunks and their
    recomputation in the backward) calls nothing whose result shape
    depends on the data or that reads a value on the host."""
    from tests.test_torch_dsv2 import _Watch

    layer = KimiDeltaAttention(SMALL, 0)
    x = _x(8).requires_grad_(True)
    watch = _Watch()
    with watch, torch.autocast("cpu", dtype=torch.bfloat16):
        layer(x).float().square().mean().backward()
    assert watch.found == [], watch.found
    assert x.grad is not None and all(p.grad is not None for p in layer.parameters())


def test_device_counters_count_the_even_share():
    obs.reset()
    model = _model()
    clouds, t, _ = _batch()
    with torch.no_grad():
        model(clouds, t)
    c = obs.snapshot()["counters"]
    obs.reset()
    assert c["moe.layer_steps"] == 4 and c["moe.experts_held"] == 4 * 8
    assert c["moe.rows_even"] == 4 * B * N * 4 * 8 // 16
    assert c["moe.rows"] == sum(int(m.choice_counts[:8].sum()) for m in model.encoder.moe_layers())


def test_closed_form_flops_are_flopcountermodes_plus_the_grouped_rows():
    model = _model()
    clouds, t, _ = _batch()
    obs.reset()
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(clouds, t)
    rows = obs.snapshot()["counters"]["moe.rows"]
    obs.reset()
    per_row = 2 * 3 * SMALL.hidden_size * SMALL.moe_intermediate_size
    expected = 4 * B * N * 4 * 8 / 16
    assert counter.get_total_flops() + per_row * rows == kimi_planenet_flops(SMALL, B, N) + per_row * (
        rows - expected)


def test_checkpoint_round_trip_restores_the_bias(tmp_path):
    """Two eager steps, a checkpoint, two more; a fresh model restored from
    the checkpoint takes the same two steps: the same weights and biases
    to the bit."""
    process = ProjectedSO3Diffusion(timesteps=20, device=CPU)
    batches = torch.randn(4, 4, N, 3, generator=torch.Generator().manual_seed(2))

    def trainer():
        model = _model(seed=5)
        opt = make_optimizer(model.named_parameters(), 1e-3)
        return model, make_dp_train_step(aircraft.make_loss_fn(model, process), model, opt), TrainState(
            model, opt, torch.Generator().manual_seed(0))

    model, step, state = trainer()
    for i in range(2):
        state, _ = step(state, batches[i])
    save_checkpoint(str(tmp_path), state)
    for i in range(2, 4):
        state, _ = step(state, batches[i])
    model2, step2, state2 = trainer()
    restore_checkpoint(str(tmp_path), state2)
    assert not torch.equal(model2.encoder.layers[1].mlp.e_score_correction_bias, torch.zeros(16))
    for i in range(2, 4):
        state2, _ = step2(state2, batches[i])
    for (name, a), b in zip(model.state_dict().items(), model2.state_dict().values()):
        assert torch.equal(a, b), name


def test_driver_trains_and_resumes_the_trunk(tmp_path, monkeypatch):
    """``--trunk`` through the aircraft driver's train(): 4 steps, K = 2, the
    checkpoint holding the moved biases; --resume to 6; --test samples."""
    monkeypatch.setitem(aircraft.TRUNKS, "small", SMALL)
    ckpt = str(tmp_path / "ck")
    flags = ["--so3", "--device", "cpu", "--trunk", "small", "--batch", "4", "--samples", "16", "--timesteps",
             "20", "--data-root", "/nonexistent", "--no-native", "--steps-per-call", "2", "--print-every", "2",
             "--ckpt", ckpt]
    state = aircraft.main(flags + ["--steps", "4"])
    saved = torch.load(os.path.join(ckpt, "step_00000004.pt"), weights_only=True)["params"]
    for i in range(1, 5):
        name = f"encoder.layers.{i}.mlp.e_score_correction_bias"
        assert torch.equal(saved[name], state.model.state_dict()[name]) and saved[name].abs().max() > 0
    resumed = aircraft.main(flags + ["--steps", "6", "--resume"])
    assert resumed.step == 6
    assert isinstance(resumed.model.encoder.layers[3].self_attn, kimi_linear.MLA)
    monkeypatch.setattr(aircraft, "SAMPLES_PER_SHAPE", 1)
    res = aircraft.main(flags + ["--test", "--max-shapes", "4"])
    assert np.isfinite(res).all()
