"""The port's Euler-angle + shift baseline (``processes/euler.py``) against
the JAX package's, on the CPU, at T = 20: the ops, the ancestral and DDIM
chains from shared noise through a small ProtNet(se3=False) (dim 32, heads
2, t_depth 2, c_depth 3) behind ``ProtProjection(se3=False)``, B = 3
synthetic pairs, the loss with its double sqrt(1 - acp) factor, and the
weight gradient against ``jax.grad``.

Randomness is shared: the port takes JAX's block-scaled init (``x_init``),
each step's unit normal noise, the loss JAX's t and noise.  The denoiser's
output layer is scaled by 0.1 on both sides, as in the SE(3) tests.  The
state's shift reaches ~75 x 3, so entries are held to a tolerance times
1 + the state's largest entry: 1e-5 a step, 1e-4 for a chain.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffusion_extensions_tpu.data.pdb import pad_prot_batch as j_pad
from diffusion_extensions_tpu.data.pdb import synthetic_prot_pair as j_pair
from diffusion_extensions_tpu.models.projections import ProtProjection as JProj
from diffusion_extensions_tpu.models.protnet import ProtNet as JProtNet
from diffusion_extensions_tpu.processes.euler import ProjectedEulerDiffusion as JEuler
from diffusion_extensions_tpu_torch.convert import protnet_config_from_flax, protnet_params_from_flax
from diffusion_extensions_tpu_torch.data.pdb import to_device
from diffusion_extensions_tpu_torch.models.projections import ProtProjection
from diffusion_extensions_tpu_torch.models.protnet import ProtNet
from diffusion_extensions_tpu_torch.processes.euler import ProjectedEulerDiffusion
from diffusion_extensions_tpu_torch.processes.r3 import GaussianDiffusion

torch.set_num_threads(1)
T, B = 20, 3
BLOCK = np.array([3.0] * 3 + [75.0] * 3, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(ours, ref, tol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours.detach().numpy(), ref, rtol=0,
                               atol=tol * (1.0 + np.abs(ref).max()))


class Setup:
    def __init__(self):
        rng = np.random.default_rng(0)
        self.batch = j_pad([j_pair(rng, 14 - 2 * i, 8 - i) for i in range(B)])
        jm = JProtNet(dim=32, heads=2, t_depth=2, c_depth=3, se3=False)
        params = jm.init(jax.random.PRNGKey(0), self.batch, jnp.zeros((B,), jnp.int32))
        params = jax.tree_util.tree_map(np.asarray, params)
        head = params["params"]["Dense_4"]  # the output layer
        head["kernel"], head["bias"] = head["kernel"] * 0.1, head["bias"] * 0.1
        self.jm, self.params = jm, params
        self.jden = jax.jit(lambda x, t: jm.apply(params, x, t))
        self.tden = self.model()
        self.jproc = JEuler.create(T)
        self.tproc = ProjectedEulerDiffusion.create(T, device="cpu")
        self.jproj = JProj(self.batch, se3=False)
        self.tbatch = to_device(self.batch, "cpu")
        self.tproj = ProtProjection(self.tbatch, se3=False)
        self.x = rng.standard_normal((B, 6)).astype(np.float32) * BLOCK
        self.t = np.array([0, 7, 19], np.int32)

    def model(self):
        tm = ProtNet(**protnet_config_from_flax(self.params), se3=False).eval()
        tm.load_state_dict(protnet_params_from_flax(self.params))
        return tm


@pytest.fixture(scope="module")
def s():
    return Setup()


def test_create_and_ops(s):
    """Defaults, the block scale, and the inherited R^n ops on the
    6-vector: rtol 1e-6."""
    p = s.tproc
    assert (p.rot_scale, p.shift_scale, p.loss_type, p.clip_denoised_default) == (
        3.0, 75.0, "grad_mse", False)
    np.testing.assert_array_equal(p._block_scale().numpy(), BLOCK)
    with pytest.raises(ValueError, match="loss_type"):
        ProjectedEulerDiffusion.create(T, loss_type="l2", device="cpu")
    assert isinstance(p, GaussianDiffusion)
    jt, tt = jnp.asarray(s.t), torch.from_numpy(s.t).long()
    n = np.random.default_rng(1).standard_normal((B, 6)).astype(np.float32)
    _close(p.q_sample(_t(s.x), tt, _t(n)), s.jproc.q_sample(s.x, jt, n), 1e-6)
    _close(p.predict_start_from_noise(_t(s.x), tt, _t(n)),
           s.jproc.predict_start_from_noise(s.x, jt, n), 1e-6)
    for a, b in zip(p.q_posterior(_t(s.x), _t(n), tt), s.jproc.q_posterior(s.x, n, jt)):
        _close(a, b, 1e-6)


def test_p_sample_block_scaled_noise(s):
    """One step with JAX's noise: the unit draw is scaled by (3, 3, 3, 75,
    75, 75), no clipping, none at t == 0."""
    jt, tt = jnp.asarray(s.t), torch.from_numpy(s.t).long()
    key = jax.random.PRNGKey(2)
    ref = s.jproc.p_sample(s.jden, key, jnp.asarray(s.x), jt, projection=s.jproj)
    noise = _t(jax.random.normal(key, (B, 6)))
    with torch.no_grad():
        ours = s.tproc.p_sample(s.tden, None, _t(s.x), tt, projection=s.tproj, noise=noise)
        mean = s.tproc.p_mean_variance(s.tden, _t(s.x), tt, False, s.tproj)[0]
    _close(ours, ref, 1e-5)
    assert torch.equal(ours[0], mean[0])


def test_ancestral_chain(s):
    """The T-step chain from JAX's block-scaled init with JAX's noise
    (split(key): init; fold_in(key, i) at timestep i)."""
    ref = s.jproc.p_sample_loop(s.jden, jax.random.PRNGKey(3), B, projection=s.jproj)
    key, init_key = jax.random.split(jax.random.PRNGKey(3))
    x0 = _t(jax.random.normal(init_key, (B, 6))) * _t(BLOCK)
    noise = _t(np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, i), (B, 6)))
                         for i in range(T - 1, -1, -1)]))
    with torch.no_grad():
        ours = s.tproc.p_sample_loop(s.tden, None, B, projection=s.tproj, x_init=x0,
                                     noise=noise)
        drawn = s.tproc.p_sample_loop(s.tden, torch.Generator().manual_seed(0), B,
                                      projection=s.tproj)
    _close(ours, ref, 1e-4)
    assert drawn.shape == (B, 6) and torch.isfinite(drawn).all()


def test_ddim_chain(s):
    """DDIM-8 with the R^n jumps from the block-scaled init, unclipped."""
    ref = s.jproc.ddim_sample_loop(s.jden, jax.random.PRNGKey(4), B, num_steps=8,
                                   projection=s.jproj)
    _, init_key = jax.random.split(jax.random.PRNGKey(4))
    x0 = _t(jax.random.normal(init_key, (B, 6))) * _t(BLOCK)
    with torch.no_grad():
        ours = s.tproc.ddim_sample_loop(s.tden, None, B, 8, projection=s.tproj, x_init=x0)
        drawn = s.tproc.ddim_sample_loop(s.tden, torch.Generator().manual_seed(0), B, 8,
                                         projection=s.tproj)
    _close(ours, ref, 1e-4)
    assert float(ours.abs().max()) > 1.0  # no clip to [-1, 1]
    assert torch.isfinite(drawn).all()


def _loss_draws(seed):
    key = jax.random.PRNGKey(seed)
    k_t, k_n = jax.random.split(key)
    t = jax.random.randint(k_t, (B,), 0, T)
    return key, torch.from_numpy(np.array(t)).long(), _t(jax.random.normal(k_n, (B, 6)))


def test_loss_with_the_double_factor(s):
    """``loss`` with JAX's t and noise: rtol 1e-5; and the noisy state it
    feeds the model is q_sample of noise x eps_t x block, so the noise is
    scaled by (1 - acp_t), not its square root: the reference's double
    factor, kept."""
    key, t, noise = _loss_draws(5)
    x0 = jnp.zeros((B, 6))
    ref = s.jproc.loss(s.jden, key, x0, s.jproj)
    with torch.no_grad():
        ours = s.tproc.loss(s.tden, None, torch.zeros(B, 6), s.tproj, t=t, noise=noise)
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5)
    seen = []
    s.tproc.p_losses(lambda x, tt: seen.append(x) or torch.zeros(B, 6), None,
                     torch.zeros(B, 6), t, noise=noise)
    one_minus = 1.0 - s.tproc.schedule.alphas_cumprod[t][:, None]
    torch.testing.assert_close(seen[0], noise * _t(BLOCK) * one_minus, rtol=1e-6, atol=0)


def test_weight_gradients_match_jax_grad(s):
    """d loss / d weights at JAX's t and noise against ``jax.grad`` through
    the converter: every entry within 1e-3 of the model's largest gradient
    entry (the SE(3) test's bound; section C.3 of ROADMAP.md measures the
    float32 spread)."""
    key, t, noise = _loss_draws(6)
    jgrads = jax.grad(lambda p: s.jproc.loss(lambda x, tt: s.jm.apply(p, x, tt), key,
                                             jnp.zeros((B, 6)), s.jproj))(s.params)
    want = protnet_params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    model = s.model()
    s.tproc.loss(model, None, torch.zeros(B, 6), s.tproj, t=t, noise=noise).backward()
    scale = max(float(v.abs().max()) for v in want.values())
    assert scale > 0.1
    for name, p in model.named_parameters():
        diff = float((p.grad - want[name]).abs().max())
        assert diff <= 1e-3 * scale, (name, diff, scale)
