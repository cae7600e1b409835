"""The port's PlaneNet and weight converter against the JAX package's flax
PlaneNet, on the CPU."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffusion_extensions_tpu.models.planenet import PlaneNet as JPlaneNet
from diffusion_extensions_tpu.models.projections import PointCloudProj as JProj
from diffusion_extensions_tpu_torch.convert import (
    planenet_config_from_flax,
    planenet_params_from_flax,
)
from diffusion_extensions_tpu_torch.models.planenet import PlaneNet
from diffusion_extensions_tpu_torch.models.projections import PointCloudProj

torch.set_num_threads(1)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(params))


@pytest.fixture(scope="module")
def small():
    """dim 64, heads 4, layers 2; B 4, N 32; inputs from numpy."""
    jm = JPlaneNet(dim=64, heads=4, layers=2)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 32, 3)).astype(np.float32)
    t = rng.integers(0, 1000, 4).astype(np.int32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t))
    tm = PlaneNet(dim=64, heads=4, layers=2).eval()
    tm.load_state_dict(planenet_params_from_flax(_np_tree(params)), strict=True)
    return jm, params, tm, x, t


def test_forward_parity_f32(small):
    """Same weights, same inputs, float32 on both sides: the outputs agree to
    ~1e-5 relative (summation order differs between the two matmul
    libraries; the Siren's scale-30 first layer amplifies input rounding)."""
    jm, params, tm, x, t = small
    ref = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        ours = tm(torch.from_numpy(x), torch.from_numpy(t).long()).numpy()
    assert ours.shape == (4, 3)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_forward_through_projection(small):
    """PointCloudProj on both sides, then the model, at a random rotation."""
    jm, params, tm, x, t = small
    from diffusion_extensions_tpu.ops.so3 import exp_skewvec

    v = np.random.default_rng(1).standard_normal((4, 3)).astype(np.float32)
    r = np.array(exp_skewvec(jnp.asarray(v)))
    jx = JProj(jnp.asarray(x))(jnp.asarray(r))
    tx = PointCloudProj(torch.from_numpy(x))(torch.from_numpy(r))
    np.testing.assert_allclose(tx, np.asarray(jx), atol=1e-6)
    ref = np.asarray(jm.apply(params, jx, jnp.asarray(t)))
    with torch.no_grad():
        ours = tm(tx, torch.from_numpy(t).long()).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_bf16_autocast_close_to_f32(small):
    """bf16 encoder matmuls keep ~3 significant digits."""
    _, _, tm, x, t = small
    tb = PlaneNet(dim=64, heads=4, layers=2, bf16=True).eval()
    tb.load_state_dict(tm.state_dict())
    with torch.no_grad():
        a = tm(torch.from_numpy(x), torch.from_numpy(t).long())
        b = tb(torch.from_numpy(x), torch.from_numpy(t).long())
    assert b.dtype == torch.float32
    np.testing.assert_allclose(b, a, atol=5e-2 * float(a.abs().max()))


def test_converter_full_width_maps_every_leaf():
    """dim 512 / heads 4 / layers 4: 12,941,060 parameters, every leaf used."""
    jm = JPlaneNet()
    shapes = jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 3)), jnp.zeros((1,), jnp.int32)
    )
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    n_flax = sum(a.size for a in jax.tree_util.tree_leaves(tree))
    assert n_flax == 12_941_060
    assert planenet_config_from_flax(tree) == {"dim": 512, "heads": 4, "layers": 4}
    sd = planenet_params_from_flax(tree)
    assert sum(v.numel() for v in sd.values()) == n_flax
    model = PlaneNet()
    assert sum(p.numel() for p in model.parameters()) == n_flax
    model.load_state_dict(sd, strict=True)


def test_converter_raises_on_bad_trees(small):
    _, params, _, _, _ = small
    tree = _np_tree(params)["params"]
    missing = {k: v for k, v in tree.items() if k != "Dense_0"}
    with pytest.raises(ValueError, match="missing"):
        planenet_params_from_flax(missing)
    extra = dict(tree, Extra_0={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="extra"):
        planenet_params_from_flax(extra)
    bad = dict(tree, Dense_0={"kernel": np.zeros((64, 4), np.float32),
                              "bias": np.zeros((3,), np.float32)})
    with pytest.raises(ValueError, match="mis-shaped"):
        planenet_params_from_flax(bad)
