"""The port's Switch MoE (``models/moe.py``), the MoE PlaneNet and the MoE
aircraft loss against the JAX package's, on the CPU: the weights from the
flax init through ``convert.py``, the inputs from a numpy seed."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffusion_extensions_tpu.experiments import aircraft as jaircraft
from diffusion_extensions_tpu.models.moe import MoEFFN as JMoEFFN
from diffusion_extensions_tpu.models.planenet import PlaneNet as JPlaneNet
from diffusion_extensions_tpu.processes.so3 import ProjectedSO3Diffusion as JProjected
from diffusion_extensions_tpu_torch.convert import (
    planenet_config_from_flax,
    planenet_params_from_flax,
)
from diffusion_extensions_tpu_torch.experiments import aircraft
from diffusion_extensions_tpu_torch.models.layers import TransformerEncoder
from diffusion_extensions_tpu_torch.models.moe import MoEFFN
from diffusion_extensions_tpu_torch.models.planenet import PlaneNet
from diffusion_extensions_tpu_torch.processes.so3 import ProjectedSO3Diffusion

torch.set_num_threads(1)
B, N, D, E, F = 4, 16, 32, 4, 64


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(0).standard_normal((B, N, D)).astype(np.float32)


def _pair(x, n_experts, cf, dispatch):
    """A flax MoEFFN (its init) and the port's with the same weights."""
    jm = JMoEFFN(D, n_experts, dim_feedforward=F, capacity_factor=cf, dispatch_impl=dispatch)
    params = {"params": jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]}
    p = _np_tree(params)["params"]
    tm = MoEFFN(D, n_experts, F, cf, dispatch)
    sd = {"router.weight": torch.tensor(p["router"]["kernel"].T),
          "router.bias": torch.tensor(p["router"]["bias"])}
    sd.update({k: torch.tensor(p[k]) for k in ("w1", "b1", "w2", "b2")})
    tm.load_state_dict(sd, strict=True)
    return jm, params, tm


def _jax_routing(params, x, n_experts, cf):
    """expert, keep and slot as the flax module computes them
    (``models/moe.py:61-119``), in JAX."""
    p = params["params"]
    tokens = jnp.asarray(x).reshape(-1, D)
    t = tokens.shape[0]
    cap = int(-(-t * cf // n_experts))
    probs = jax.nn.softmax(tokens @ p["router"]["kernel"] + p["router"]["bias"], axis=-1)
    expert = jnp.argmax(probs, axis=-1)
    onehot = jax.nn.one_hot(expert, n_experts, dtype=jnp.float32)
    pos = jnp.sum(jnp.cumsum(onehot, axis=0) * onehot, axis=-1) - 1.0
    keep = pos < cap
    pos = jnp.clip(pos, 0, cap - 1).astype(jnp.int32)
    slot = jnp.where(keep, expert.astype(jnp.int32) * cap + pos, n_experts * cap)
    return np.asarray(expert), np.asarray(keep), np.asarray(slot), cap


@pytest.mark.parametrize("cf", [1.25, 0.25])
@pytest.mark.parametrize("dispatch", ["onehot", "scatter"])
def test_moe_ffn_matches_flax(x, dispatch, cf):
    """Expert, kept mask and slot equal exactly; the output within 1e-5 of
    its scale; the load-balance loss within rtol 1e-6; the expert
    fractions equal."""
    jm, params, tm = _pair(x, E, cf, dispatch)
    ref, st = jm.apply(params, jnp.asarray(x), mutable=["losses", "diag"])
    out = tm(torch.from_numpy(x))
    expert, keep, slot, cap = _jax_routing(params, x, E, cf)
    _, _, t_expert, t_keep, t_pos = tm.route(torch.from_numpy(x).reshape(-1, D))
    t_slot = torch.where(t_keep, t_expert * cap + t_pos, E * cap)
    np.testing.assert_array_equal(t_expert.numpy(), expert)
    np.testing.assert_array_equal(t_keep.numpy(), keep)
    np.testing.assert_array_equal(t_slot.numpy(), slot)
    assert tm.capacity(B * N) == cap
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    (aux,) = jax.tree_util.tree_leaves(st["losses"])
    np.testing.assert_allclose(float(tm.aux_loss.detach()), float(aux), rtol=1e-6)
    (frac,) = jax.tree_util.tree_leaves(st["diag"])
    np.testing.assert_array_equal(tm.expert_frac.numpy(), np.asarray(frac))
    if cf < 1:
        assert not keep.all()  # the tight arm drops tokens


def test_single_expert_is_a_dense_ffn(x):
    """E = 1 with capacity above T routes every token with gate 1 through
    the one expert: the output is the plain FFN on the same weights."""
    tm = MoEFFN(D, 1, F, capacity_factor=2.0)
    xt = torch.from_numpy(x)
    tokens = xt.reshape(-1, D)
    want = torch.relu(tokens @ tm.w1[0] + tm.b1[0]) @ tm.w2[0] + tm.b2[0]
    torch.testing.assert_close(tm(xt), want.reshape(B, N, D), rtol=1e-5, atol=1e-6)
    assert float(tm.aux_loss) == 1.0


def test_capacity_drops_tokens(x):
    """Capacity below T / E: the tokens past it give exactly zero, and the
    kept ones are the first in token order."""
    tm = MoEFFN(D, 1, F, capacity_factor=0.25)
    flat = tm(torch.from_numpy(x)).reshape(-1, D)
    cap = int(np.ceil(B * N * 0.25))
    zero = (flat.abs().amax(dim=1) == 0).numpy()
    assert zero.sum() == B * N - cap
    assert not zero[:cap].any() and zero[cap:].all()


@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_scatter_dispatch_matches_onehot(x, cf):
    """The two dispatches: the same outputs, aux and gradients, the dropped
    tokens included."""
    torch.manual_seed(1)
    a = MoEFFN(D, E, F, cf, "onehot")
    b = MoEFFN(D, E, F, cf, "scatter")
    b.load_state_dict(a.state_dict())
    xa = torch.from_numpy(x).requires_grad_(True)
    xb = torch.from_numpy(x).requires_grad_(True)
    ya, yb = a(xa), b(xb)
    torch.testing.assert_close(yb, ya, rtol=1e-5, atol=1e-6)
    assert float(a.aux_loss) == float(b.aux_loss)
    (ya ** 2).sum().backward()
    (yb ** 2).sum().backward()
    torch.testing.assert_close(xb.grad, xa.grad, rtol=1e-4, atol=1e-5)
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        torch.testing.assert_close(pb.grad, pa.grad, rtol=1e-4, atol=1e-5, msg=name)


def test_moe_encoder_and_protnet_defaults():
    """The encoder's MoE layers default to one-hot dispatch (the JAX
    layers'), PlaneNet's to scatter; a dense encoder holds no MoE."""
    enc = TransformerEncoder(D, 4, 2, moe_experts=E)
    assert all(layer.moe.dispatch == "onehot" for layer in enc.layers)
    assert all(not hasattr(layer, "ff1") for layer in enc.layers)
    assert PlaneNet(dim=D, heads=2, layers=1, moe_experts=E).encoder.layers[0].moe.dispatch \
        == "scatter"
    assert all(layer.moe is None for layer in TransformerEncoder(D, 4, 2).layers)
    with pytest.raises(ValueError, match="unknown dispatch"):
        MoEFFN(D, E, F, dispatch="gather")


@pytest.fixture(scope="module")
def planenet():
    """The flax MoE PlaneNet (dim 64, 4 heads, 2 layers, 4 experts) and the
    port's from its init; clouds (B 4 x 32 points) and t from numpy."""
    jm = JPlaneNet(dim=64, heads=4, layers=2, moe_experts=E)
    rng = np.random.default_rng(1)
    clouds = rng.standard_normal((4, 32, 3)).astype(np.float32)
    t = rng.integers(0, 100, 4).astype(np.int32)
    params = {"params": jm.init(jax.random.PRNGKey(0), jnp.asarray(clouds),
                                jnp.asarray(t))["params"]}
    tree = _np_tree(params)
    cfg = planenet_config_from_flax(tree)
    tm = PlaneNet(**cfg)
    tm.load_state_dict(planenet_params_from_flax(tree), strict=True)
    return jm, params, tm, cfg, clouds, t


def test_planenet_config_and_converter(planenet):
    _, params, tm, cfg, _, _ = planenet
    assert cfg == {"dim": 64, "heads": 4, "layers": 2, "moe_experts": E}
    n_flax = sum(a.size for a in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in tm.parameters()) == n_flax
    tree = _np_tree(params)["params"]
    layer = tree["TransformerEncoder_0"]["TransformerEncoderLayer_1"]
    bad = dict(layer, MoEFFN_0=dict(layer["MoEFFN_0"], w1=np.zeros((E, 64, 8), np.float32)))
    enc = dict(tree["TransformerEncoder_0"], TransformerEncoderLayer_1=bad)
    with pytest.raises(ValueError, match="mis-shaped"):
        planenet_params_from_flax(dict(tree, TransformerEncoder_0=enc))


def test_planenet_moe_forward_matches_flax(planenet):
    """Forward within 1e-5 of its scale; aux summed over the layers and the
    per-layer expert fractions as flax sows them."""
    jm, params, tm, _, clouds, t = planenet
    ref, st = jm.apply(params, jnp.asarray(clouds), jnp.asarray(t), mutable=["losses", "diag"])
    with torch.no_grad():
        out = tm(torch.from_numpy(clouds), torch.from_numpy(t).long())
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    np.testing.assert_allclose(float(tm.moe_aux()), float(sum(jax.tree_util.tree_leaves(
        st["losses"]))), rtol=1e-6)
    np.testing.assert_array_equal(tm.expert_fracs().numpy(),
                                  np.stack(jax.tree_util.tree_leaves(st["diag"])))


@pytest.mark.parametrize("aux_weight", [0.01, 0.0])
def test_aircraft_loss_with_aux_matches_jax(planenet, aux_weight):
    """``make_loss_fn`` with the JAX loss's t and noise fed through the
    batch: rtol 1e-4, with and without the aux term."""
    jm, params, tm, _, clouds, _ = planenet
    jproc = JProjected(100)
    truepos = jnp.broadcast_to(jnp.eye(3), (4, 3, 3))
    key = jax.random.PRNGKey(3)
    ref = jaircraft.make_loss_fn(jm, jproc, truepos, so3=True, aux_weight=aux_weight)(
        params, key, jnp.asarray(clouds))
    k_t, k_n = jax.random.split(key)
    t = jax.random.randint(k_t, (4,), 0, 100)
    noise = jproc.sample_noise(k_n, t)
    loss = aircraft.make_loss_fn(tm, ProjectedSO3Diffusion(100, device="cpu"),
                                 aux_weight=aux_weight)(
        None, (torch.from_numpy(clouds), torch.from_numpy(np.array(t)).long(),
               torch.from_numpy(np.array(noise))))
    np.testing.assert_allclose(float(loss), float(ref), rtol=1e-4)


def test_aircraft_loss_includes_the_aux(planenet):
    """The aux term is in the loss and in its gradient: the router's
    weights get a gradient only through it (top-1 routing is piecewise
    constant in them, the gate aside)."""
    _, _, tm, _, clouds, _ = planenet
    proc = ProjectedSO3Diffusion(100, device="cpu")
    rng = np.random.default_rng(5)
    t = torch.from_numpy(rng.integers(0, 100, 4))
    noise = proc.sample_noise(torch.Generator().manual_seed(6), t)
    batch = (torch.from_numpy(clouds), t, noise)
    with_aux = aircraft.make_loss_fn(tm, proc)(None, batch)
    no_aux = aircraft.make_loss_fn(tm, proc, aux_weight=0.0)(None, batch)
    np.testing.assert_allclose(float(with_aux - no_aux), 0.01 * float(tm.moe_aux()), rtol=1e-4)
    tm.zero_grad()
    with_aux.backward()
    g_with = tm.encoder.layers[0].moe.router.weight.grad.clone()
    tm.zero_grad()
    no_aux.backward()
    g_without = tm.encoder.layers[0].moe.router.weight.grad
    assert not torch.allclose(g_with, g_without)
