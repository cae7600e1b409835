"""The port's train step against the JAX package's ``make_dp_train_step`` on
a one-device mesh, on the CPU: a 20-step trajectory from one JAX init for
PlaneNet (the aircraft loss) and RotPredict (the Bingham loss), K-step calls,
norm logging, the non-finite skip, and a start from a converted mid-training
optimizer state.

The two packages see the same batches, t and noise: the JAX step's keys are
derived here as ``parallel/dp.py:58-61`` and ``processes/so3.py:590-592``
derive them, and the resulting t and noise are handed to the port.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

from diffusion_extensions_tpu.experiments import aircraft as jaircraft
from diffusion_extensions_tpu.models.planenet import PlaneNet as JPlaneNet
from diffusion_extensions_tpu.models.rot_predict import RotPredict as JRotPredict
from diffusion_extensions_tpu.ops import so3 as jso3
from diffusion_extensions_tpu.parallel.dp import make_dp_train_step as j_make_step
from diffusion_extensions_tpu.processes.so3 import ProjectedSO3Diffusion as JProjected
from diffusion_extensions_tpu.processes.so3 import SO3Diffusion as JSO3Diffusion
from diffusion_extensions_tpu.train.optim import make_optimizer as j_make_optimizer
from diffusion_extensions_tpu.train.state import TrainState as JTrainState
from diffusion_extensions_tpu_torch.convert import (
    adam_state_from_optax,
    planenet_params_from_flax,
    rot_predict_params_from_flax,
)
from diffusion_extensions_tpu_torch.experiments import aircraft
from diffusion_extensions_tpu_torch.models.planenet import PlaneNet
from diffusion_extensions_tpu_torch.models.rot_predict import RotPredict
from diffusion_extensions_tpu_torch.parallel.dp import make_dp_train_step
from diffusion_extensions_tpu_torch.processes.so3 import ProjectedSO3Diffusion, SO3Diffusion
from diffusion_extensions_tpu_torch.train.optim import make_optimizer
from diffusion_extensions_tpu_torch.train.state import TrainState

torch.set_num_threads(1)
T, B, LR, STEPS = 100, 8, 1e-3, 20
# flax's top-level module names and the port's
PLANENET_MODULES = {"Siren_0": "siren", "TransformerEncoder_0": "encoder",
                    "PoolRN_0": "pool", "Dense_0": "head"}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _mesh():
    return Mesh(np.asarray(jax.devices()[:1]), ("dp",))


def _step_randomness(jproc, state_key, step: int):
    """(t, noise, next state key) of the JAX step at ``step``."""
    key = jax.random.fold_in(state_key, step)
    step_key, next_key = jax.random.split(key)
    local_key = jax.random.fold_in(step_key, 0)  # mesh position 0
    k_t, k_n = jax.random.split(local_key)
    t = jax.random.randint(k_t, (B,), 0, T)
    return t, jproc.sample_noise(k_n, t), next_key


class Setup:
    """One model kind's JAX and port sides from one JAX init."""

    def __init__(self, kind: str, **opt):
        rng = np.random.default_rng(0)
        self.kind = kind
        if kind == "planenet":
            self.batches = rng.standard_normal((STEPS + 4, B, 16, 3)).astype(np.float32)
            self.jmodel = JPlaneNet(dim=32, heads=2, layers=1)
            self.jproc = JProjected(T)
            params = self.jmodel.init(jax.random.PRNGKey(0), jnp.asarray(self.batches[0]),
                                      jnp.zeros((B,), jnp.int32))
            truepos = jnp.broadcast_to(jnp.eye(3), (B, 3, 3))
            self.jloss = jaircraft.make_loss_fn(self.jmodel, self.jproc, truepos, so3=True)
            self.convert = planenet_params_from_flax
            self.tmodel = PlaneNet(dim=32, heads=2, layers=1)
            self.tproc = ProjectedSO3Diffusion(T, device="cpu")
            self.tloss = aircraft.make_loss_fn(self.tmodel, self.tproc)
        else:
            v = rng.standard_normal((STEPS + 4, B, 3)).astype(np.float32)
            self.batches = np.array(jso3.exp_skewvec(jnp.asarray(v)))
            self.jmodel = JRotPredict(d_model=65, out_type="skewvec")
            self.jproc = JSO3Diffusion.create(T)
            params = self.jmodel.init(jax.random.PRNGKey(0), jnp.asarray(self.batches[0]),
                                      jnp.zeros((B,), jnp.int32))
            self.jloss = lambda p, key, batch: self.jproc.loss(
                lambda x, t: self.jmodel.apply(p, x, t), key, batch)
            self.convert = rot_predict_params_from_flax
            self.tmodel = RotPredict(65, "skewvec")
            self.tproc = SO3Diffusion.create(T, device="cpu")

            def tloss(gen, batch):
                x, t, noise = batch
                return self.tproc.loss(self.tmodel, gen, x, t=t, noise=noise)

            self.tloss = tloss
        self.params = params
        self.tx = j_make_optimizer(LR, **opt)
        self.jstate = JTrainState.create(params, self.tx, jax.random.PRNGKey(1))
        self.tmodel.load_state_dict(self.convert(_np_tree(params)), strict=True)
        self.optimizer = make_optimizer(self.tmodel.named_parameters(), LR, **opt)
        self.tstate = TrainState(self.tmodel, self.optimizer, torch.Generator().manual_seed(0))

    def jstep_fn(self, **kw):
        return j_make_step(self.jloss, self.tx, _mesh(), donate=False, **kw)

    def tstep_fn(self, **kw):
        return make_dp_train_step(self.tloss, self.tmodel, self.optimizer, **kw)

    def port_batch(self, i: int):
        """Batch i with the t and noise that the JAX step at ``jstate``
        draws for it."""
        t, noise, _ = _step_randomness(self.jproc, self.jstate.key, int(self.jstate.step))
        return (torch.from_numpy(self.batches[i]), torch.from_numpy(np.array(t)).long(),
                torch.from_numpy(np.array(noise)))

    def check_weights(self, tol: float, outlier_tol: float, key_tol: float) -> None:
        """Every leaf against the converted JAX weights: all entries within
        ``outlier_tol`` and at least 99.9% of them within ``tol``.  Adam
        normalises each gradient entry by its own size, so an entry that is
        small because its terms cancel turns its rounding noise, which
        differs between two matmul libraries, into a difference of a
        fraction of lr a step.  The attention's key projection is held to
        ``key_tol`` only: the gradient of its bias, and of the half of its
        weight that reads the time token (the same for every point), is
        zero in exact arithmetic (softmax does not see a shift common to
        all keys), so there Adam normalises nothing but noise."""
        want = self.convert(_np_tree(self.jstate.params))
        for k, p in self.tmodel.named_parameters():
            diff = (p.detach() - want[k]).abs()
            if ".key." in k:
                assert float(diff.max()) < key_tol, (k, float(diff.max()))
                continue
            assert float(diff.max()) < outlier_tol, (k, float(diff.max()))
            assert float((diff > tol).float().mean()) <= 1e-3, (k, float(diff.max()))


@pytest.mark.parametrize("kind", ["planenet", "rot_predict"])
def test_twenty_step_trajectory_matches_jax(kind):
    """Loss of every step rtol 1e-4; final weights after 20 steps at lr 1e-3:
    at least 99.9% of each leaf's entries within 5 * lr * 1e-2 = 5e-5 and
    all within lr / 2 (measured for PlaneNet: 13 of 139,028 entries outside
    the key projection above 5e-5, the largest 2.3e-4; the key projection,
    held to 5 lr, 1.2e-3), see ``check_weights``."""
    s = Setup(kind)
    jstep, tstep = s.jstep_fn(), s.tstep_fn()
    for i in range(STEPS):
        batch = s.port_batch(i)
        s.jstate, jmetrics = jstep(s.jstate, jnp.asarray(s.batches[i]))
        s.tstate, tmetrics = tstep(s.tstate, batch)
        np.testing.assert_allclose(float(tmetrics["loss"]), float(jmetrics["loss"]), rtol=1e-4,
                                   err_msg=f"step {i}")
    assert s.tstate.step == int(s.jstate.step) == STEPS
    s.check_weights(tol=5 * LR * 1e-2, outlier_tol=LR / 2, key_tol=5 * LR)


def test_steps_per_call_equals_single_steps():
    """One call with a (4, B, ...) batch equals four calls (atol 1e-6; the
    bits, in fact: the same draws from the same generator), reports the
    last sub-step's metrics, and takes a shorter tail batch."""
    a, b = Setup("rot_predict"), Setup("rot_predict")
    step1 = make_dp_train_step(lambda g, x: a.tproc.loss(a.tmodel, g, x), a.tmodel, a.optimizer)
    step4 = make_dp_train_step(lambda g, x: b.tproc.loss(b.tmodel, g, x), b.tmodel, b.optimizer,
                               steps_per_call=4)
    batches = torch.from_numpy(a.batches[:4])
    for x in batches:
        a.tstate, m1 = step1(a.tstate, x)
    b.tstate, m4 = step4(b.tstate, batches)
    assert a.tstate.step == b.tstate.step == 4
    np.testing.assert_allclose(float(m4["loss"]), float(m1["loss"]), rtol=1e-6)
    for pa, pb in zip(a.tmodel.parameters(), b.tmodel.parameters()):
        np.testing.assert_allclose(pb.detach().numpy(), pa.detach().numpy(), atol=1e-6)
    b.tstate, _ = step4(b.tstate, batches[:3])  # the exact tail of --steps
    assert b.tstate.step == 7
    with pytest.raises(ValueError, match="5 sub-batches"):
        step4(b.tstate, torch.from_numpy(a.batches[:5]))


def test_log_norms_and_per_layer_norms_match_jax():
    """grad_norm, param_norm and grad_norm/<module> after one step against
    JAX's (rtol 1e-4), module by module; with K = 3 they are the last
    sub-step's."""
    s = Setup("planenet")
    kw = dict(log_norms=True, per_layer_norms=True)
    batch = s.port_batch(0)
    _, jm = s.jstep_fn(**kw)(s.jstate, jnp.asarray(s.batches[0]))
    s.tstate, tmetrics = s.tstep_fn(**kw)(s.tstate, batch)
    want = {"loss", "grad_norm", "param_norm"} | {f"grad_norm/{m}" for m in
                                                  PLANENET_MODULES.values()}
    assert set(tmetrics) == want
    assert set(jm) == {"loss", "grad_norm", "param_norm"} | {f"grad_norm/{m}" for m in
                                                             PLANENET_MODULES}
    for key in ("grad_norm", "param_norm"):
        np.testing.assert_allclose(float(tmetrics[key]), float(jm[key]), rtol=1e-4)
    for flax_name, name in PLANENET_MODULES.items():
        np.testing.assert_allclose(float(tmetrics[f"grad_norm/{name}"]),
                                   float(jm[f"grad_norm/{flax_name}"]), rtol=1e-4)
    total = sum(float(tmetrics[f"grad_norm/{m}"]) ** 2 for m in PLANENET_MODULES.values())
    np.testing.assert_allclose(total, float(tmetrics["grad_norm"]) ** 2, rtol=1e-5)
    # without log_norms no norm is computed
    assert set(s.tstep_fn()(s.tstate, batch)[1]) == {"loss"}

    # K = 3: the norms of the last sub-step, as three single steps report them
    a, b = Setup("rot_predict"), Setup("rot_predict")
    one = make_dp_train_step(lambda g, x: a.tproc.loss(a.tmodel, g, x), a.tmodel, a.optimizer,
                             log_norms=True)
    three = make_dp_train_step(lambda g, x: b.tproc.loss(b.tmodel, g, x), b.tmodel, b.optimizer,
                               log_norms=True, steps_per_call=3)
    batches = torch.from_numpy(a.batches[:3])
    for x in batches:
        a.tstate, m1 = one(a.tstate, x)
    b.tstate, m3 = three(b.tstate, batches)
    for key in ("grad_norm", "param_norm"):
        assert float(m3[key]) > 0
        np.testing.assert_allclose(float(m3[key]), float(m1[key]), rtol=1e-6)


def test_skip_nonfinite_holds_weights_and_advances_the_step():
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 1)
    optimizer = make_optimizer(model.named_parameters(), 1e-2)

    def loss_fn(gen, batch):
        x, poison = batch
        return torch.mean(model(x) ** 2) / (1.0 - poison[0])

    step = make_dp_train_step(loss_fn, model, optimizer, skip_nonfinite=True)
    state = TrainState(model, optimizer, torch.Generator())
    x = torch.ones(8, 4)
    clean, poisoned = (x, torch.zeros(8)), (x, torch.ones(8))
    state, m1 = step(state, clean)
    assert np.isfinite(float(m1["loss"]))
    before = [p.detach().clone() for p in model.parameters()]
    moments = [m.clone() for m in optimizer.mu + optimizer.nu]
    state, m2 = step(state, poisoned)
    assert not np.isfinite(float(m2["loss"]))
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(), before))
    assert all(torch.equal(p, q) for p, q in zip(optimizer.mu + optimizer.nu, moments))
    assert state.step == 2 and int(optimizer.count) == 1  # the step advances, Adam's count holds
    state, _ = step(state, clean)
    assert any(not torch.equal(p, q) for p, q in zip(model.parameters(), before))
    # without the flag the non-finite update goes through, as in the JAX package
    loose = make_dp_train_step(loss_fn, model, optimizer)
    loose(state, poisoned)
    assert not all(torch.isfinite(p).all() for p in model.parameters())


@pytest.mark.parametrize("opt", [dict(clip=1.0), dict(impl="fused", state_dtype="bf16")],
                         ids=["optax-clip", "fused-bf16"])
def test_start_from_converted_optimizer_state_matches_next_jax_step(opt):
    """Five JAX steps, then weights and Adam state carried over
    (``adam_state_from_optax``); the sixth step of both agrees: loss rtol
    1e-5, weights atol 1e-6 (measured 3e-8; with bf16 moments both read the
    same bits), the key projection lr / 2 (measured 8.3e-5 with bf16
    moments, 4.9e-6 with float32 ones; see ``check_weights``)."""
    s = Setup("planenet", **opt)
    jstep = s.jstep_fn()
    for i in range(5):
        s.jstate, _ = jstep(s.jstate, jnp.asarray(s.batches[i]))
    adam = s.jstate.opt_state
    if opt.get("impl") != "fused":
        adam = adam[1][0]  # chain(clip, adam): (EmptyState, (ScaleByAdamState, EmptyState))
    bf16 = opt.get("state_dtype") == "bf16"
    to_np = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda a: np.asarray(a.astype(jnp.float32)), tree)
    state = adam_state_from_optax(to_np(adam.mu), to_np(adam.nu), int(adam.count),
                                  torch.bfloat16 if bf16 else torch.float32)
    s.tmodel.load_state_dict(s.convert(_np_tree(s.jstate.params)))
    s.optimizer.load_state_dict(state)
    s.tstate.step = int(s.jstate.step)
    assert int(s.optimizer.count) == 5
    batch = s.port_batch(5)
    s.jstate, jm = jstep(s.jstate, jnp.asarray(s.batches[5]))
    s.tstate, tmetrics = s.tstep_fn()(s.tstate, batch)
    np.testing.assert_allclose(float(tmetrics["loss"]), float(jm["loss"]), rtol=1e-5)
    s.check_weights(tol=1e-6, outlier_tol=1e-6, key_tol=LR / 2)


def test_steps_per_call_takes_a_nested_namedtuple_batch():
    """A K-stacked batch of NamedTuples (the protein driver's ProtBatch of
    ProtData, with a bool mask) is split field by field: one call of K = 3
    equals three single steps to the bit."""
    from typing import NamedTuple

    class Inner(NamedTuple):
        x: torch.Tensor
        w: torch.Tensor

    class Outer(NamedTuple):
        inner: Inner
        mask: torch.Tensor

    def loss_fn(model):
        def fn(gen, batch):
            noise = torch.randn(batch.mask.shape, generator=gen)
            pred = model(batch.inner.x)[..., 0] * batch.inner.w + noise
            return torch.mean(torch.where(batch.mask, pred, 0.0) ** 2)
        return fn

    rng = np.random.default_rng(0)
    batches = Outer(Inner(torch.from_numpy(rng.standard_normal((3, 8, 4)).astype(np.float32)),
                          torch.from_numpy(rng.standard_normal((3, 8)).astype(np.float32))),
                    torch.from_numpy(rng.uniform(size=(3, 8)) > 0.3))
    runs = []
    for k in (1, 3):
        torch.manual_seed(0)
        model = torch.nn.Linear(4, 1)
        opt = make_optimizer(model.named_parameters(), 1e-2)
        state = TrainState(model, opt, torch.Generator().manual_seed(1))
        step = make_dp_train_step(loss_fn(model), model, opt, steps_per_call=k)
        if k == 1:
            for i in range(3):
                state, m = step(state, Outer(Inner(batches.inner.x[i], batches.inner.w[i]),
                                             batches.mask[i]))
        else:
            state, m = step(state, batches)
        runs.append((float(m["loss"]), [p.detach().clone() for p in model.parameters()]))
        assert state.step == 3
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
