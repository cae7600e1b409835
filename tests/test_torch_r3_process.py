"""The port's R^n diffusion process (``processes/r3.py``) against the JAX
package's, on the CPU, at T = 20, B = 5, state (B, 3): every op, the four
samplers (ancestral, DDIM, Picard, interpolate) and both losses, with
clipping (``GaussianDiffusion.create``) and without
(``ProjectedGaussianDiffusion``, behind the Euler arm's ``PointCloudProj``).
Then the reference's own goldens: the R^n keys of
``tests/goldens/processes.npz`` and the Euler aircraft chain of
``tests/goldens/euler_ref_parity.npz``.

Randomness is shared, never re-drawn: the port takes JAX's initial state
(``x_init``), each step's normal noise (``noise``), and the losses JAX's
t and noise, rebuilt here from JAX's keys as its samplers split them.  The
denoiser is a two-layer tanh MLP on shared numpy weights on both sides.
Tolerances: 1e-6 relative for one op, 1e-5 a model step, 1e-4 for a chain.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffusion_extensions_tpu.models.projections import PointCloudProj as JProj
from diffusion_extensions_tpu.processes.r3 import GaussianDiffusion as JGauss
from diffusion_extensions_tpu.processes.r3 import ProjectedGaussianDiffusion as JProjGauss
from diffusion_extensions_tpu_torch.models.projections import PointCloudProj
from diffusion_extensions_tpu_torch.ops.so3 import rmat_to_euler
from diffusion_extensions_tpu_torch.processes.r3 import (
    GaussianDiffusion,
    ProjectedGaussianDiffusion,
)

torch.set_num_threads(1)
T, B, D, N = 20, 5, 3, 8
OP_RTOL, STEP_TOL, CHAIN_TOL = 1e-6, 1e-5, 1e-4


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


class Setup:
    def __init__(self):
        rng = np.random.default_rng(0)
        self.w1 = rng.standard_normal((D + 1, 16)).astype(np.float32) * 0.5
        self.w2 = rng.standard_normal((16, D)).astype(np.float32) * 0.5
        self.wc = rng.standard_normal((N * 3 + 1, 16)).astype(np.float32) * 0.2
        self.data = rng.standard_normal((B, N, 3)).astype(np.float32)
        self.x = rng.standard_normal((B, D)).astype(np.float32) * 1.5
        self.noise = rng.standard_normal((B, D)).astype(np.float32)
        self.t = np.array([0, 1, 7, 13, 19], np.int32)

    def jden(self, x, t):
        h = jnp.tanh(jnp.concatenate((x, (t.astype(jnp.float32) / T)[:, None]), -1) @ self.w1)
        return h @ self.w2

    def tden(self, x, t):
        h = torch.tanh(torch.cat((x, (t.float() / T)[:, None]), -1) @ _t(self.w1))
        return h @ _t(self.w2)

    def jden_cloud(self, clouds, t):
        flat = clouds.reshape(clouds.shape[0], -1)
        h = jnp.tanh(jnp.concatenate((flat, (t.astype(jnp.float32) / T)[:, None]), -1) @ self.wc)
        return h @ self.w2

    def tden_cloud(self, clouds, t):
        flat = clouds.reshape(clouds.shape[0], -1)
        h = torch.tanh(torch.cat((flat, (t.float() / T)[:, None]), -1) @ _t(self.wc))
        return h @ _t(self.w2)


@pytest.fixture(scope="module")
def s():
    return Setup()


ARMS = {
    "clipped_l2": (lambda: JGauss.create(T, "l2"), lambda: GaussianDiffusion.create(T, "l2",
                                                                                   device="cpu"),
                   False),
    "clipped_l1": (lambda: JGauss.create(T, "l1"), lambda: GaussianDiffusion.create(T, "l1",
                                                                                   device="cpu"),
                   False),
    "projected_l1": (lambda: JProjGauss(T), lambda: ProjectedGaussianDiffusion(T, device="cpu"),
                     True),
    "projected_l2": (lambda: JProjGauss(T, "l2"),
                     lambda: ProjectedGaussianDiffusion(T, "l2", device="cpu"), True),
}


def _arm(s, name):
    """(JAX process, port process, JAX denoise, port denoise, JAX projection,
    port projection) of one arm: the projected arms see the state through
    the Euler ``PointCloudProj``."""
    jmake, tmake, projected = ARMS[name]
    if projected:
        return (jmake(), tmake(), s.jden_cloud, s.tden_cloud,
                JProj(jnp.asarray(s.data), so3=False), PointCloudProj(_t(s.data), so3=False))
    return jmake(), tmake(), s.jden, s.tden, None, None


def _close(ours, ref, rtol=0.0, atol=0.0):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=rtol, atol=atol)


def test_create_defaults_and_schedule():
    j, t = JGauss.create(T), GaussianDiffusion.create(T, device="cpu")
    for name in ("betas", "sqrt_alphas_cumprod", "posterior_log_variance_clipped",
                 "sqrt_recipm1_alphas_cumprod"):
        np.testing.assert_array_equal(getattr(t.schedule, name).numpy(),
                                      np.asarray(getattr(j.schedule, name)))
    assert (t.loss_type, t.clip_denoised_default, t.num_timesteps) == ("l2", True, T)
    p = ProjectedGaussianDiffusion(T, device="cpu")
    assert (p.loss_type, p.clip_denoised_default) == ("l1", False)
    for bad in (lambda: GaussianDiffusion.create(T, "l3", device="cpu"),
                lambda: ProjectedGaussianDiffusion(T, "huber", device="cpu")):
        with pytest.raises(ValueError, match="loss_type"):
            bad()


def test_forward_ops(s):
    """q_mean_variance, q_sample, predict_start_from_noise, q_posterior on
    shared inputs: rtol 1e-6."""
    j, p = JGauss.create(T), GaussianDiffusion.create(T, device="cpu")
    jt, tt = jnp.asarray(s.t), torch.from_numpy(s.t).long()
    x, n = _t(s.x), _t(s.noise)
    for ours, ref in zip(p.q_mean_variance(x, tt), j.q_mean_variance(jnp.asarray(s.x), jt)):
        _close(ours, ref, OP_RTOL, 1e-7)
    _close(p.q_sample(x, tt, n), j.q_sample(s.x, jt, s.noise), OP_RTOL, 1e-7)
    _close(p.predict_start_from_noise(x, tt, n), j.predict_start_from_noise(s.x, jt, s.noise),
           OP_RTOL, 1e-6)
    for ours, ref in zip(p.q_posterior(x, n, tt), j.q_posterior(s.x, s.noise, jt)):
        _close(ours, ref, OP_RTOL, 1e-7)


@pytest.mark.parametrize("clip", [True, False])
def test_p_mean_variance(s, clip):
    j, p = JGauss.create(T), GaussianDiffusion.create(T, device="cpu")
    jt, tt = jnp.asarray(s.t), torch.from_numpy(s.t).long()
    x = s.x * 3.0  # large enough that clipping acts
    ours = p.p_mean_variance(s.tden, _t(x), tt, clip)
    ref = j.p_mean_variance(s.jden, jnp.asarray(x), jt, clip)
    for a, b in zip(ours, ref):
        _close(a, b, STEP_TOL, STEP_TOL)
    if clip:  # the clip changes the mean at the late timesteps
        free = p.p_mean_variance(s.tden, _t(x), tt, False)[0]
        assert not torch.allclose(free, ours[0])


@pytest.mark.parametrize("arm", list(ARMS))
def test_p_sample_with_jax_noise(s, arm):
    """One step with JAX's key's noise, the clip default of each arm."""
    jproc, tproc, jden, tden, jproj, tproj = _arm(s, arm)
    jt, tt = jnp.asarray(s.t), torch.from_numpy(s.t).long()
    key = jax.random.PRNGKey(1)
    x = s.x * 2.0
    ref = jproc.p_sample(jden, key, jnp.asarray(x), jt, projection=jproj)
    noise = _t(jax.random.normal(key, x.shape))
    ours = tproc.p_sample(tden, None, _t(x), tt, projection=tproj, noise=noise)
    _close(ours, ref, STEP_TOL, STEP_TOL)
    # t == 0 takes no noise
    assert torch.equal(ours[0], tproc.p_sample(tden, None, _t(x), tt, projection=tproj,
                                               noise=noise * 0)[0])


def _ancestral_draws(seed, shape):
    """JAX p_sample_loop's init and per-step noises: split(key) for the init,
    fold_in(key, i) at timestep i; noise[j] is the step at t = T - 1 - j."""
    key, init_key = jax.random.split(jax.random.PRNGKey(seed))
    x0 = jax.random.normal(init_key, shape)
    noise = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, i), shape))
                      for i in range(T - 1, -1, -1)])
    return x0, noise


@pytest.mark.parametrize("arm", list(ARMS))
def test_ancestral_chain(s, arm):
    """The T-step chain from JAX's x_init with JAX's noise: 1e-4; and the
    port's own draw is reproducible from one seed."""
    jproc, tproc, jden, tden, jproj, tproj = _arm(s, arm)
    ref = jproc.p_sample_loop(jden, jax.random.PRNGKey(2), (B, D), projection=jproj)
    x0, noise = _ancestral_draws(2, (B, D))
    ours = tproc.p_sample_loop(tden, None, (B, D), projection=tproj, x_init=_t(x0),
                               noise=_t(noise))
    _close(ours, ref, CHAIN_TOL, CHAIN_TOL)
    a = tproc.p_sample_loop(tden, torch.Generator().manual_seed(0), (B, D), projection=tproj)
    b = tproc.p_sample_loop(tden, torch.Generator().manual_seed(0), (B, D), projection=tproj)
    assert torch.equal(a, b) and torch.isfinite(a).all()
    if tproc.clip_denoised_default:
        assert float(ours.abs().max()) <= 1.0 + 1e-6  # the last step is the clipped mean


@pytest.mark.parametrize("arm", list(ARMS))
def test_ddim_chain(s, arm):
    jproc, tproc, jden, tden, jproj, tproj = _arm(s, arm)
    ref = jproc.ddim_sample_loop(jden, jax.random.PRNGKey(3), (B, D), num_steps=7,
                                 projection=jproj)
    _, init_key = jax.random.split(jax.random.PRNGKey(3))
    x0 = _t(jax.random.normal(init_key, (B, D)))
    ours = tproc.ddim_sample_loop(tden, None, (B, D), 7, projection=tproj, x_init=x0)
    _close(ours, ref, CHAIN_TOL, CHAIN_TOL)


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("tol", [0.0, 1e-4])
def test_picard_matches_jax_and_the_port_s_ddim(s, tol, clip):
    """Picard over 16 grid points with tol 0 runs to the sequential DDIM
    chain (at most 16 sweeps: it also stops at a sweep that moves nothing,
    which depends on the last bit); with tol 1e-4 it stops where JAX's
    stops (16 sweeps clipped, where the clip keeps moving the increments,
    9 unclipped)."""
    if clip:
        jproc, tproc = JGauss.create(T), GaussianDiffusion.create(T, device="cpu")
    else:
        jproc, tproc = JProjGauss(T), ProjectedGaussianDiffusion(T, device="cpu")
    ref, jk = jproc.parallel_sample_loop(s.jden, jax.random.PRNGKey(4), (B, D), num_steps=16,
                                         tol=tol, return_sweeps=True)
    _, init_key = jax.random.split(jax.random.PRNGKey(4))
    x0 = _t(jax.random.normal(init_key, (B, D)))
    ours, k = tproc.parallel_sample_loop(s.tden, None, (B, D), 16, tol=tol,
                                         return_sweeps=True, x_init=x0)
    _close(ours, ref, CHAIN_TOL, CHAIN_TOL)
    if tol == 0.0:
        assert k <= 16
        _close(ours, tproc.ddim_sample_loop(s.tden, None, (B, D), 16, x_init=x0), 1e-5, 1e-5)
    else:
        assert k == int(jk) == (16 if clip else 9)


def test_interpolate(s):
    """JAX's interpolate at t = 12, lam 0.3: split(key, 3) for the two ends'
    noises, fold_in(key, i) a chain step."""
    jproc, tproc = JGauss.create(T), GaussianDiffusion.create(T, device="cpu")
    x1, x2 = s.x, s.noise * 0.5
    key = jax.random.PRNGKey(5)
    ref = jproc.interpolate(s.jden, key, jnp.asarray(x1), jnp.asarray(x2), t=12, lam=0.3)
    key, k1, k2 = jax.random.split(key, 3)
    chain = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, i), x1.shape))
                      for i in range(11, -1, -1)])
    ours = tproc.interpolate(s.tden, None, _t(x1), _t(x2), t=12, lam=0.3,
                             noise=(_t(jax.random.normal(k1, x1.shape)),
                                    _t(jax.random.normal(k2, x2.shape)), _t(chain)))
    _close(ours, ref, CHAIN_TOL, CHAIN_TOL)
    drawn = tproc.interpolate(s.tden, torch.Generator().manual_seed(1), _t(x1), _t(x2))
    assert drawn.shape == (B, D) and torch.isfinite(drawn).all()


@pytest.mark.parametrize("arm", list(ARMS))
def test_loss_with_jax_t_and_noise(s, arm):
    """``loss`` with JAX's t and noise (split(key): randint, normal): rtol
    1e-6; the projected arms regress the Euler state at zero through the
    clouds, as the aircraft Euler arm does."""
    jproc, tproc, jden, tden, jproj, tproj = _arm(s, arm)
    key = jax.random.PRNGKey(6)
    k_t, k_n = jax.random.split(key)
    t = jax.random.randint(k_t, (B,), 0, T)
    x0 = np.zeros((B, D), np.float32) if jproj is not None else s.x
    ref = jproc.loss(jden, key, jnp.asarray(x0), projection=jproj)
    ours = tproc.loss(tden, None, _t(x0), projection=tproj,
                      t=torch.from_numpy(np.array(t)).long(),
                      noise=_t(jax.random.normal(k_n, x0.shape)))
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)
    drawn = tproc.loss(tden, torch.Generator().manual_seed(0), _t(x0), projection=tproj)
    assert torch.isfinite(drawn)


# -- the reference's goldens ------------------------------------------------
@pytest.fixture(scope="module")
def gold():
    return np.load("tests/goldens/processes.npz")


def test_gaussian_process_golden(gold):
    """``q_samp``, ``pred_x0`` and ``post_mean`` (and the posterior's
    variance) of the reference at T = 100, as ``tests/test_processes.py``
    holds the JAX package to them."""
    proc = GaussianDiffusion.create(100, betas=gold["betas"], device="cpu")
    t = torch.from_numpy(gold["t"]).long()
    x, noise = _t(gold["x"]), _t(gold["noise"])
    _close(proc.q_sample(x, t, noise), gold["q_samp"], atol=1e-5)
    _close(proc.predict_start_from_noise(x, t, noise), gold["pred_x0"], 1e-4, 1e-4)
    pm, pv, plv = proc.q_posterior(x, _t(gold["q_samp"]), t)
    _close(pm, gold["post_mean"], atol=1e-5)
    _close(pv, gold["post_var"], atol=1e-7)
    _close(plv, gold["post_logvar"], atol=1e-4)


class EulerRef:
    """The reference's Euler aircraft chain (``euler_ref_parity.npz``: a
    tiny tanh MLP on the flattened projected clouds, 40 steps)."""

    def __init__(self):
        g = np.load("tests/goldens/euler_ref_parity.npz")
        self.g, self.T = g, int(g["timesteps"])
        self.proc = ProjectedGaussianDiffusion(self.T, device="cpu")
        self.proj = PointCloudProj(_t(g["data"]), so3=False)
        self.w = {k[2:]: _t(g[k]) for k in g.files if k.startswith("w_")}

    def denoise(self, x, t):
        w = self.w
        h = torch.cat((x.reshape(x.shape[0], -1), (t.float() / self.T)[:, None]), -1)
        h = torch.tanh(h @ w["l1_weight"].T + w["l1_bias"])
        h = torch.tanh(h @ w["l2_weight"].T + w["l2_bias"])
        return h @ w["l3_weight"].T + w["l3_bias"]

    def states(self):
        """The state before each reverse step, t = T - 1 first."""
        return np.concatenate([self.g["init_euler"][None], self.g["states"][:-1]], axis=0)


@pytest.fixture(scope="module")
def ref():
    return EulerRef()


def test_euler_ref_schedule_and_haar_init(ref):
    g = ref.g
    np.testing.assert_allclose(ref.proc.schedule.betas.numpy(), g["betas"], rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(ref.proc.schedule.posterior_log_variance_clipped.numpy(),
                               g["posterior_log_variance_clipped"], rtol=1e-5, atol=1e-6)
    eul = torch.stack(rmat_to_euler(_t(g["init_rots"])), dim=-1)
    _close(eul, g["init_euler"], 1e-5, 1e-5)


def test_euler_ref_denoiser_input_path(ref):
    """eps_hat on the golden pre-step states: euler_to_rmat, the Euler
    ``PointCloudProj`` and the MLP in one."""
    for idx, i in enumerate(reversed(range(ref.T))):
        x = _t(ref.states()[idx])
        eps = ref.denoise(ref.proj(x), torch.full((x.shape[0],), i))
        _close(eps, ref.g["eps_preds"][idx], 2e-4, 2e-5)


def test_euler_ref_stepwise_mean_logvar_and_update(ref):
    """Re-anchored at the golden state each step: the posterior mean and
    log-variance, and ``p_sample`` with the golden noise."""
    g = ref.g
    for idx, i in enumerate(reversed(range(ref.T))):
        x = _t(ref.states()[idx])
        t = torch.full((x.shape[0],), i)
        mean, _, logvar = ref.proc.p_mean_variance(ref.denoise, x, t, False, ref.proj)
        scale = max(1.0, float(np.abs(g["means"][idx]).max()))
        _close(mean, g["means"][idx], 5e-4, 5e-5 * scale)
        _close(logvar.expand(x.shape[0], 1), g["logvars"][idx], 1e-5, 1e-6)
        nxt = ref.proc.p_sample(ref.denoise, None, x, t, projection=ref.proj,
                                noise=_t(g["chain_noise"][idx]))
        _close(nxt, g["states"][idx], 5e-4, 5e-5 * scale)


def test_euler_ref_free_running_chain(ref):
    """The 40-step chain from the Haar-Euler init with the golden noise,
    through ``p_sample_loop``: within 2e-3 of the final state's size."""
    g = ref.g
    x = ref.proc.p_sample_loop(ref.denoise, None, g["init_euler"].shape, projection=ref.proj,
                               x_init=_t(g["init_euler"]), noise=_t(g["chain_noise"]))
    final = g["states"][-1]
    assert float(np.abs(x.numpy() - final).max()) < 2e-3 * float(np.abs(final).max())


def test_euler_ref_p_losses(ref):
    g = ref.g
    b = g["init_euler"].shape[0]
    for k, tv in enumerate(g["loss_t"]):
        loss = ref.proc.p_losses(ref.denoise, None, torch.zeros(b, 3),
                                 torch.full((b,), int(tv)), ref.proj,
                                 noise=_t(g["loss_noise"][k]))
        np.testing.assert_allclose(float(loss), g["losses"][k], rtol=1e-4, atol=1e-6)
