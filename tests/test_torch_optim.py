"""The port's optimizer against the JAX package's ``make_optimizer`` on the
CPU: the same gradient sequence (numpy-seeded, with a leaf of zeros and a
leaf of 1e-12 magnitudes) through both, for every implementation, clip and
schedule, and for the fused implementation with bf16 moments."""
import argparse

import numpy as np
import jax.numpy as jnp
import optax
import pytest
import torch

from diffusion_extensions_tpu.train import optim as joptim
from diffusion_extensions_tpu_torch.train import optim as toptim

torch.set_num_threads(1)
LR, TOTAL, UPDATES = 1e-2, 10, 12  # 12 updates cross the cosine schedule's floor
SHAPES = {"w": (37, 19), "b": (19,), "zeros": (5,), "tiny": (7, 3)}


def _grads(i):
    """Update i's gradients: O(1) entries whose norm crosses clip = 1.0 both
    ways over the sequence, a leaf of zeros, a leaf of 1e-12 magnitudes."""
    rng = np.random.default_rng(100 + i)
    scale = 0.02 if i % 3 == 0 else 1.0
    g = {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in SHAPES.items()}
    g["zeros"] = np.zeros(SHAPES["zeros"], np.float32)
    g["tiny"] = (rng.standard_normal(SHAPES["tiny"]) * 1e-12).astype(np.float32)
    return g


def _port_optimizer(**kw):
    params = [(k, torch.nn.Parameter(torch.zeros(s))) for k, s in SHAPES.items()]
    return params, toptim.make_optimizer(params, LR, **kw)


CASES = [
    pytest.param(impl, clip, schedule, "f32", id=f"{impl}-clip{clip}-{schedule}")
    for impl in ("optax", "fused") for clip in (0.0, 1.0) for schedule in ("const", "cosine")
] + [pytest.param("fused", 1.0, "cosine", "bf16", id="fused-clip1.0-cosine-bf16")]


@pytest.mark.parametrize("impl,clip,schedule,state_dtype", CASES)
def test_updates_match_jax_make_optimizer(impl, clip, schedule, state_dtype):
    """Each of 12 updates, and the moments after them, against optax's:
    rtol 1e-5 with float32 moments, and atol 2e-7 of the leaf's largest
    entry (an entry that is small because two terms of the moment cancel
    carries the absolute rounding of those terms: measured 1.05e-9 on an
    update of 4.5e-5 beside updates of 1e-2, with the clip on, whose norm
    the two packages sum in another order).  With bf16 moments the stored
    moments agree to one bf16 ulp (2^-7 relative) and the updates, which
    read them, to rtol 2e-2."""
    kw = dict(clip=clip, schedule=schedule, total_steps=TOTAL, impl=impl,
              state_dtype=state_dtype)
    tx = joptim.make_optimizer(LR, **kw)
    jparams = {k: jnp.zeros(s) for k, s in SHAPES.items()}
    jstate = tx.init(jparams)
    params, opt = _port_optimizer(**kw)
    bf16 = state_dtype == "bf16"
    norms = []
    for i in range(UPDATES):
        g = _grads(i)
        norms.append(float(np.sqrt(sum((v.astype(np.float64) ** 2).sum() for v in g.values()))))
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        for k, p in params:
            p.data.zero_()  # Adam does not read the weights: p after the step is the update
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, p in params:
            ref = np.asarray(updates[k])
            np.testing.assert_allclose(
                p.detach().numpy(), ref, rtol=2e-2 if bf16 else 1e-5,
                atol=2e-7 * np.abs(ref).max(), err_msg=f"update {i}, leaf {k}")
    assert min(norms) < 1.0 < max(norms)  # the clip both triggers and does not
    assert int(opt.count) == UPDATES
    jadam = jstate if impl == "fused" else (jstate[1] if clip else jstate)[0]
    assert int(jadam.count) == UPDATES
    for name, mine in (("mu", opt.mu), ("nu", opt.nu)):
        for k, m in zip(opt.names, mine):
            ref = np.asarray(getattr(jadam, name)[k].astype(jnp.float32))
            assert m.dtype == (torch.bfloat16 if bf16 else torch.float32)
            np.testing.assert_allclose(m.float().numpy(), ref, rtol=2.0 ** -7 if bf16 else 1e-5,
                                       atol=2e-7 * np.abs(ref).max(), err_msg=f"{name}[{k}]")


def test_learning_rate_at_steps_0_1_and_total():
    """The schedule is read at the pre-increment count: the first update
    uses schedule(0) = lr; ``final_frac`` is the floor from ``total_steps``."""
    sched = optax.cosine_decay_schedule(init_value=LR, decay_steps=TOTAL, alpha=0.1)
    _, opt = _port_optimizer(schedule="cosine", total_steps=TOTAL)
    for k in (0, 1, TOTAL // 2, TOTAL, TOTAL + 5):
        np.testing.assert_allclose(float(opt.learning_rate(k)), float(sched(k)), rtol=1e-6)
    assert float(opt.learning_rate(0)) == np.float32(LR)
    np.testing.assert_allclose(float(opt.learning_rate(TOTAL)), 0.1 * LR, rtol=1e-6)
    _, const = _port_optimizer()
    assert float(const.learning_rate(0)) == float(const.learning_rate(10**6)) == np.float32(LR)
    # a first Adam update has size lr * g / (|g| + eps): the first step's lr is schedule(0)
    params, opt = _port_optimizer(schedule="cosine", total_steps=TOTAL)
    for _, p in params:
        p.grad = torch.ones_like(p)
    opt.step()
    np.testing.assert_allclose(params[0][1].detach().numpy(), -LR, rtol=1e-5)


@pytest.mark.parametrize("kw,message", [
    (dict(schedule="cosine"), "cosine schedule needs total_steps"),
    (dict(schedule="linear"), "unknown lr schedule: 'linear'"),
    (dict(state_dtype="f16"), "unknown opt state dtype: 'f16'"),
    (dict(state_dtype="bf16"), "--opt-state-dtype bf16 requires --opt-impl fused"),
    (dict(impl="lion"), "unknown optimizer impl: 'lion'"),
])
def test_make_optimizer_errors_are_the_jax_packages(kw, message):
    with pytest.raises(ValueError) as ours:
        _port_optimizer(**kw)
    with pytest.raises(ValueError) as ref:
        joptim.make_optimizer(LR, **kw)
    assert str(ours.value) == str(ref.value) == message


def test_step_without_a_gradient_raises():
    params, opt = _port_optimizer()
    with pytest.raises(RuntimeError, match="parameter w has no gradient"):
        opt.step()
    with pytest.raises(ValueError, match="no parameters"):
        toptim.make_optimizer([], LR)


def test_state_dict_round_trip_and_mismatches():
    params, opt = _port_optimizer(impl="fused", state_dtype="bf16")
    for k, p in params:
        p.grad = torch.from_numpy(_grads(0)[k])
    opt.step()
    state = opt.state_dict()
    _, fresh = _port_optimizer(impl="fused", state_dtype="bf16")
    fresh.load_state_dict(state)
    assert int(fresh.count) == 1
    for a, b in zip(opt.mu + opt.nu, fresh.mu + fresh.nu):
        assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b)
    _, f32 = _port_optimizer()
    with pytest.raises(ValueError, match="same --opt-state-dtype"):
        f32.load_state_dict(state)
    bad = dict(state, mu={k: v for k, v in state["mu"].items() if k != "b"})
    with pytest.raises(ValueError, match=r"missing \['b'\]"):
        fresh.load_state_dict(bad)


def test_add_optim_flags_match_the_jax_parser():
    def flags(module):
        p = argparse.ArgumentParser()
        module.add_optim_flags(p)
        return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.type)
                for a in p._actions if a.dest != "help"}

    ours, ref = flags(toptim), flags(joptim)
    assert ours == ref
    assert set(ours) == {"clip", "lr_schedule", "opt_impl", "opt_state_dtype"}
