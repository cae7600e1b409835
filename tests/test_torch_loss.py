"""The port's SO(3) training losses against the JAX package's, on the CPU:
``p_losses`` / ``loss`` for both loss types, with and without a projection,
value and gradients with respect to every (converted) weight, and
``rmat_dist`` under autograd.

Randomness is shared, never re-drawn: t comes from numpy and the noise from
the JAX process (``sample_noise(key, t)`` with the key ``p_losses`` is
given), passed to the port as ``noise=``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffusion_extensions_tpu.models.planenet import PlaneNet as JPlaneNet
from diffusion_extensions_tpu.models.projections import PointCloudProj as JProj
from diffusion_extensions_tpu.models.rot_predict import RotPredict as JRotPredict
from diffusion_extensions_tpu.ops import metrics as jm
from diffusion_extensions_tpu.ops import so3 as jso3
from diffusion_extensions_tpu.processes.so3 import ProjectedSO3Diffusion as JProjected
from diffusion_extensions_tpu.processes.so3 import SO3Diffusion as JSO3Diffusion
from diffusion_extensions_tpu_torch.convert import (
    planenet_params_from_flax,
    rot_predict_params_from_flax,
)
from diffusion_extensions_tpu_torch.models.planenet import PlaneNet
from diffusion_extensions_tpu_torch.models.projections import PointCloudProj
from diffusion_extensions_tpu_torch.models.rot_predict import RotPredict
from diffusion_extensions_tpu_torch.ops import metrics as tm
from diffusion_extensions_tpu_torch.processes.so3 import ProjectedSO3Diffusion, SO3Diffusion

torch.set_num_threads(1)
T, B = 100, 8


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _rots(n, seed, scale=1.0):
    v = np.random.default_rng(seed).standard_normal((n, 3)).astype(np.float32) * scale
    return np.array(jso3.exp_skewvec(jnp.asarray(v)))


def _case(name):
    """(jax loss of params, jax params, port model, port loss of the model,
    converter) for one of the four cases; t from numpy, noise from JAX."""
    rng = np.random.default_rng(3)
    t = rng.integers(0, T, B).astype(np.int32)
    key = jax.random.PRNGKey(5)
    loss_type = "prevstep" if name.startswith("prevstep") else "skewvec"
    if name == "skewvec_projected":
        clouds = rng.standard_normal((B, 16, 3)).astype(np.float32)
        jmodel = JPlaneNet(dim=32, heads=2, layers=1)
        params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(clouds), jnp.asarray(t))
        jproc = JProjected(T, loss_type)
        tproc = ProjectedSO3Diffusion(T, loss_type, device="cpu")
        x_start = np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3)).copy()
        jproj, tproj = JProj(jnp.asarray(clouds)), PointCloudProj(torch.from_numpy(clouds))
        tmodel, convert = PlaneNet(dim=32, heads=2, layers=1), planenet_params_from_flax
    else:
        out_type = "rotmat" if loss_type == "prevstep" else "skewvec"
        x_start = _rots(B, 4)
        jmodel = JRotPredict(d_model=65, out_type=out_type)
        params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x_start), jnp.asarray(t))
        jproc = JSO3Diffusion.create(T, loss_type)
        tproc = SO3Diffusion.create(T, loss_type, device="cpu")
        tmodel, convert = RotPredict(65, out_type), rot_predict_params_from_flax
        jproj = tproj = None
        if name.endswith("projected"):
            # any map of the state will do as a projection: a fixed left product
            r0 = _rots(1, 6)[0]
            jproj = lambda x: jnp.asarray(r0) @ x  # noqa: E731
            tproj = lambda x: torch.from_numpy(r0) @ x  # noqa: E731
    params = _np_tree(params)
    tmodel.load_state_dict(convert(params), strict=True)
    noise = np.array(jproc.sample_noise(key, jnp.asarray(t)))

    def jloss(p):
        return jproc.p_losses(lambda x, tt: jmodel.apply(p, x, tt), key,
                              jnp.asarray(x_start), jnp.asarray(t), jproj)

    def tloss():
        return tproc.p_losses(tmodel, None, torch.from_numpy(x_start),
                              torch.from_numpy(t).long(), tproj,
                              noise=torch.from_numpy(noise))

    return jloss, params, tmodel, tloss, convert


@pytest.mark.parametrize("name", ["skewvec_projected", "skewvec_plain", "prevstep_plain",
                                  "prevstep_projected"])
def test_p_losses_value_and_weight_gradients_match_jax(name):
    """Value rtol 1e-5; the gradient of every weight against ``jax.grad``
    mapped through the converter: rtol 1e-4, atol 1e-6 times the largest
    gradient entry of the leaf or 1e-6, whichever is larger (the two matmul
    libraries sum in another order).  The prevstep loss differentiates
    through Gram-Schmidt, sqrt and atan2, and takes atol 1e-5 on the same
    scale (measured 5.6e-6)."""
    jloss, params, tmodel, tloss, convert = _case(name)
    ref, jgrads = jax.value_and_grad(jloss)(params)
    ours = tloss()
    np.testing.assert_allclose(float(ours.detach()), float(ref), rtol=1e-5)
    ours.backward()
    want = convert(_np_tree(jgrads))
    got = {k: p.grad for k, p in tmodel.named_parameters()}
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        w = want[k].numpy()
        assert np.abs(w).max() > 0, k
        atol = (1e-5 if name.startswith("prevstep") else 1e-6) * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=atol, err_msg=k)


def test_noise_carries_no_gradient_and_is_drawn_when_absent():
    proc = SO3Diffusion.create(T, device="cpu")
    model = RotPredict(65, "skewvec")
    x = torch.from_numpy(_rots(B, 1))
    t = torch.full((B,), 50)
    noise = torch.from_numpy(_rots(B, 2, 0.3)).requires_grad_(True)
    proc.p_losses(model, None, x, t, noise=noise).backward()
    assert noise.grad is None
    with torch.no_grad():
        a = proc.p_losses(model, torch.Generator().manual_seed(1), x, t)
        b = proc.p_losses(model, torch.Generator().manual_seed(1), x, t)
        c = proc.p_losses(model, torch.Generator().manual_seed(2), x, t)
    assert float(a) == float(b) != float(c)


def test_loss_takes_t_and_noise_and_matches_jax_loss():
    """``loss(t=, noise=)`` is ``p_losses``; JAX's ``loss`` with the same
    key gives that value when the port gets JAX's own t and noise
    (derived as ``so3.py:590-592`` derives them)."""
    jmodel = JRotPredict(d_model=65, out_type="skewvec")
    x = _rots(B, 7)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.zeros((B,), jnp.int32))
    tmodel = RotPredict(65, "skewvec")
    tmodel.load_state_dict(rot_predict_params_from_flax(_np_tree(params)))
    jproc = JSO3Diffusion.create(T)
    key = jax.random.PRNGKey(9)
    ref = jproc.loss(lambda xx, tt: jmodel.apply(params, xx, tt), key, jnp.asarray(x))
    k_t, k_n = jax.random.split(key)
    t = jax.random.randint(k_t, (B,), 0, T)
    noise = jproc.sample_noise(k_n, t)
    proc = SO3Diffusion.create(T, device="cpu")
    ours = proc.loss(tmodel, None, torch.from_numpy(x), t=torch.from_numpy(np.array(t)).long(),
                     noise=torch.from_numpy(np.array(noise)))
    np.testing.assert_allclose(float(ours.detach()), float(ref), rtol=1e-5)


def test_loss_draws_t_uniform_on_0_T():
    """20,000 draws at T = 10: every value of [0, T) and no other, each
    count within 5 sigma of n / T."""
    proc = SO3Diffusion.create(10, device="cpu")
    seen = []

    def denoise(x, t):
        seen.append(t)
        return torch.zeros(x.shape[0], 3)

    n = 20_000
    x = torch.eye(3).expand(n, 3, 3)
    proc.loss(denoise, torch.Generator().manual_seed(0), x)
    counts = np.bincount(seen[0].numpy(), minlength=10)
    assert seen[0].dtype == torch.long and counts.shape == (10,) and counts.sum() == n
    sigma = np.sqrt(n * 0.1 * 0.9)
    assert np.abs(counts - n / 10).max() < 5 * sigma, counts


def test_unknown_loss_type_raises():
    with pytest.raises(ValueError, match="Unexpected loss_type"):
        SO3Diffusion.create(10, "l2", device="cpu")
    with pytest.raises(ValueError, match="Unexpected loss_type"):
        ProjectedSO3Diffusion(10, "l2", device="cpu")


def test_rmat_dist_value_and_gradient_match_jax():
    """Away from input == target: value 1e-6, gradient of sum(dist^2) 1e-4."""
    a, b = _rots(32, 10), _rots(32, 11)
    ref = np.asarray(jm.rmat_dist(jnp.asarray(a), jnp.asarray(b)))
    ta = torch.from_numpy(a).requires_grad_(True)
    ours = tm.rmat_dist(ta, torch.from_numpy(b))
    np.testing.assert_allclose(ours.detach().numpy(), ref, atol=1e-6)
    (ours ** 2).sum().backward()
    jg = jax.grad(lambda x: jnp.sum(jm.rmat_dist(x, jnp.asarray(b)) ** 2))(jnp.asarray(a))
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-4)


def test_rmat_dist_at_zero_angle():
    """At input == target the distance is 0 in both packages; sqrt'(0) is
    infinite, so the gradient of the distance itself is not finite in
    either (both give NaN: inf times the zero gradient of the skew part),
    while the gradient of the squared distance, what the prevstep loss
    takes, is NaN as well: the loss is tested away from this set."""
    a = _rots(4, 12)
    ta = torch.from_numpy(a).requires_grad_(True)
    d = tm.rmat_dist(ta, torch.from_numpy(a))
    jd = jm.rmat_dist(jnp.asarray(a), jnp.asarray(a))
    np.testing.assert_allclose(d.detach().numpy(), 0.0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(jd), 0.0, atol=1e-6)
    (d ** 2).sum().backward()
    jg = jax.grad(lambda x: jnp.sum(jm.rmat_dist(x, jnp.asarray(a)) ** 2))(jnp.asarray(a))
    assert not torch.isfinite(ta.grad).all()
    assert not np.isfinite(np.asarray(jg)).all()
