"""The port's RotPredict and its weight converter against the JAX package's
flax RotPredict, on the CPU: both variants, both heads."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffusion_extensions_tpu.models.rot_predict import RotPredict as JRotPredict
from diffusion_extensions_tpu.ops.so3 import exp_skewvec
from diffusion_extensions_tpu_torch.convert import (
    rot_predict_config_from_flax,
    rot_predict_params_from_flax,
)
from diffusion_extensions_tpu_torch.models.rot_predict import RotPredict

torch.set_num_threads(1)
B = 16


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(params))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((B, 3)).astype(np.float32)
    x = np.array(exp_skewvec(jnp.asarray(v)))
    t = rng.integers(0, 1000, B).astype(np.int32)
    return x, t


def _pair(d_model, out_type, variant, seed=0):
    jm = JRotPredict(d_model=d_model, out_type=out_type, variant=variant)
    x, t = _inputs(seed)
    params = _np_tree(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(t)))
    cfg = rot_predict_config_from_flax(params)
    assert cfg == {"d_model": d_model, "out_type": out_type, "variant": variant}
    tm = RotPredict(**cfg).eval()
    tm.load_state_dict(rot_predict_params_from_flax(params), strict=True)
    return jm, params, tm, x, t


@pytest.mark.parametrize("variant,d_model", [("mlp", 65), ("resnet", 33)])
@pytest.mark.parametrize("out_type", ["skewvec", "rotmat"])
def test_forward_parity(variant, d_model, out_type):
    """Converted weights, same inputs, float32 on both sides: 1e-5."""
    jm, params, tm, x, t = _pair(d_model, out_type, variant)
    ref = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        ours = tm(torch.from_numpy(x), torch.from_numpy(t).long()).numpy()
    assert ours.shape == ((B, 3) if out_type == "skewvec" else (B, 3, 3))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


def test_single_timestep_broadcasts():
    """t of shape (1,) is broadcast over the batch, as in flax."""
    jm, params, tm, x, _ = _pair(65, "skewvec", "mlp", seed=1)
    t1 = np.array([321], np.int32)
    ref = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(t1)))
    with torch.no_grad():
        ours = tm(torch.from_numpy(x), torch.from_numpy(t1).long()).numpy()
    assert ours.shape == (B, 3)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


def test_init_matches_flax_distribution():
    """The seeded init has flax's Dense init: LeCun truncated normal, zero
    bias.  Weight std of each hidden layer within 10% of 1/sqrt(fan_in)."""
    torch.manual_seed(0)
    m = RotPredict(65, "skewvec", "mlp").requires_grad_(False)
    for lin in list(m.hidden) + [m.out]:
        assert float(lin.bias.abs().max()) == 0.0
        std = float(lin.weight.std())
        assert abs(std - 65 ** -0.5) < 0.1 * 65 ** -0.5, std


def test_converter_rejects_bad_trees():
    _, params, _, _, _ = _pair(65, "skewvec", "mlp")
    p = params["params"]
    missing = {"params": {k: v for k, v in p.items() if k != "Dense_2"}}
    with pytest.raises(ValueError, match="missing"):
        rot_predict_params_from_flax(missing)
    extra = {"params": {**p, "Dense_5": p["Dense_4"]}}
    with pytest.raises(ValueError, match="extra"):
        rot_predict_params_from_flax(extra)
    bad = {"params": {**p, "Dense_1": {"kernel": np.zeros((65, 64), np.float32),
                                       "bias": p["Dense_1"]["bias"]}}}
    with pytest.raises(ValueError, match="mis-shaped"):
        rot_predict_params_from_flax(bad)
    head = {"params": {**p, "Dense_4": {"kernel": np.zeros((65, 4), np.float32),
                                        "bias": np.zeros((4,), np.float32)}}}
    with pytest.raises(ValueError, match="head width"):
        rot_predict_params_from_flax(head)
    with pytest.raises(ValueError, match="not a flax RotPredict"):
        rot_predict_config_from_flax({"params": {"Siren_0": {}}})
    _, rparams, _, _, _ = _pair(33, "skewvec", "resnet")
    rp = rparams["params"]
    short = {k: v for k, v in rp.items() if k != "ResMLPBlock_5"}
    with pytest.raises(ValueError, match="missing"):
        rot_predict_params_from_flax(short)
