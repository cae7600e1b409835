"""The port's SO(3) diffusion process and samplers against the JAX package's,
on the CPU, at T = 50 with a small PlaneNet (dim 64, heads 4, layers 2)
behind PointCloudProj, B = 4 clouds of 32 points.

Randomness is shared, never re-drawn: the port's samplers take JAX's noise
(``p_sample(noise=...)``) and JAX's initial rotations (``x_init``).

The denoiser's head is scaled by 0.1 on both sides, so that its prediction
has the size of a trained model's.  At the random init's size,
sqrt(1/acp - 1) * v reaches hundreds of radians near t = T-1, the x0
estimate lands anywhere on SO(3), and log near pi makes the chain chaotic:
two float32 runs of the same chain part after a few steps.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffusion_extensions_tpu.models.planenet import PlaneNet as JPlaneNet
from diffusion_extensions_tpu.models.projections import PointCloudProj as JProj
from diffusion_extensions_tpu.ops.so3 import exp_skewvec, haar_rotations
from diffusion_extensions_tpu.processes.so3 import (
    ProjectedSO3Diffusion as JProjectedSO3Diffusion,
    pf_time_grid as jpf_time_grid,
)
from diffusion_extensions_tpu_torch.convert import planenet_params_from_flax
from diffusion_extensions_tpu_torch.models.planenet import PlaneNet
from diffusion_extensions_tpu_torch.models.projections import PointCloudProj
from diffusion_extensions_tpu_torch.processes.so3 import (
    ProjectedSO3Diffusion,
    pf_time_grid,
)

torch.set_num_threads(1)
T, B, N = 50, 4, 32


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float32))


class Setup:
    def __init__(self):
        rng = np.random.default_rng(0)
        self.data = rng.standard_normal((B, N, 3)).astype(np.float32) * 0.5
        self.jproc = JProjectedSO3Diffusion(T)
        self.tproc = ProjectedSO3Diffusion(T, device="cpu")
        jm = JPlaneNet(dim=64, heads=4, layers=2)
        params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, N, 3)), jnp.zeros((1,), jnp.int32))
        params = jax.tree_util.tree_map(np.asarray, params)
        head = params["params"]["Dense_0"]
        head["kernel"], head["bias"] = head["kernel"] * 0.1, head["bias"] * 0.1
        self.jden = jax.jit(lambda x, t: jm.apply(params, x, t))
        tm = PlaneNet(dim=64, heads=4, layers=2).eval()
        tm.load_state_dict(planenet_params_from_flax(params))
        self.tden = tm
        self.jproj = JProj(jnp.asarray(self.data))
        self.tproj = PointCloudProj(_t(self.data))
        v = rng.standard_normal((B, 3)).astype(np.float32) * 2.0
        self.rots = np.asarray(exp_skewvec(jnp.asarray(v)))
        self.t = np.array([0, 1, 25, 49], dtype=np.int32)


@pytest.fixture(scope="module")
def s():
    return Setup()


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=0)


def test_schedule_and_tables(s):
    """Buffers and tables are built in numpy on both sides: equal.  The
    p-table's sigma comes from a float32 exp on each side (an ulp apart),
    which the steep tails of its quantile rows amplify, so the p-table is
    held equal when built from JAX's sigma."""
    for name in ("sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
                 "posterior_mean_coef1", "posterior_mean_coef2",
                 "sqrt_recipm1_alphas_cumprod", "posterior_log_variance_clipped"):
        np.testing.assert_array_equal(
            getattr(s.tproc.schedule, name).numpy(),
            np.asarray(getattr(s.jproc.schedule, name)),
        )
    np.testing.assert_array_equal(s.tproc.q_table.inv_cdf.numpy(),
                                  np.asarray(s.jproc.q_table.inv_cdf))
    np.testing.assert_allclose(s.tproc.p_table.eps.numpy(),
                               np.asarray(s.jproc.p_table.eps), rtol=1e-6)
    from diffusion_extensions_tpu_torch.ops.igso3 import IGSO3Table

    p_table = IGSO3Table.from_eps(np.asarray(s.jproc.p_table.eps), device="cpu")
    np.testing.assert_array_equal(p_table.inv_cdf.numpy(), np.asarray(s.jproc.p_table.inv_cdf))
    for grid, steps in (("karras", 10), ("uniform", 10), ("karras", 49)):
        assert pf_time_grid(s.tproc.schedule, steps, grid) == \
            np.asarray(jpf_time_grid(s.jproc.schedule, steps, grid)).tolist()


def test_forward_process_ops(s):
    """q_sample / predict_start_from_noise / q_posterior / q_mean_variance:
    closed-form rotation algebra, float32 on both sides: 1e-5."""
    jt, tt = jnp.asarray(s.t), torch.from_numpy(s.t).long()
    jr, tr = jnp.asarray(s.rots), _t(s.rots)
    noise = np.asarray(s.jproc.q_table.sample(jax.random.PRNGKey(1), jt))
    jn, tn = jnp.asarray(noise), _t(noise)
    _close(s.tproc.q_sample(tr, tt, tn), s.jproc.q_sample(jr, jt, jn), 1e-5)
    vec = np.random.default_rng(2).standard_normal((B, 3)).astype(np.float32) * 0.3
    _close(s.tproc.predict_start_from_noise(tr, tt, _t(vec)),
           s.jproc.predict_start_from_noise(jr, jt, jnp.asarray(vec)), 1e-5)
    xt = s.jproc.q_sample(jr, jt, jn)
    for a, b in zip(s.tproc.q_posterior(tr, _t(xt), tt), s.jproc.q_posterior(jr, xt, jt)):
        _close(a, b, 1e-5)
    for a, b in zip(s.tproc.q_mean_variance(tr, tt), s.jproc.q_mean_variance(jr, jt)):
        _close(a, b, 1e-5)


def test_p_sample_with_injected_noise(s):
    """One reverse step through the model.  The model's prediction agrees to
    ~1e-5 relative and is scaled by sqrt(1/acp - 1) (up to ~60 at t = 49)
    inside exp: 1e-4 on the rotation entries."""
    jt, tt = jnp.asarray(s.t), torch.from_numpy(s.t).long()
    key = jax.random.PRNGKey(3)
    jx = haar_rotations(key, (B,))
    noise = s.jproc.p_table.sample(key, jt)
    ref = s.jproc.p_sample(s.jden, key, jx, jt, s.jproj)
    with torch.no_grad():
        ours = s.tproc.p_sample(s.tden, None, _t(jx), tt, s.tproj, noise=_t(noise))
    _close(ours, ref, 1e-4)


def test_ancestral_chain_step_by_step(s):
    """The whole T-step chain, each step fed JAX's noise
    p_table.sample(fold_in(key, i), t).  Each step from JAX's own state
    agrees to 1e-4 (one model evaluation); the port's chain run on its own
    from JAX's Haar init stays within 1e-3 of JAX's at every step."""
    key = jax.random.PRNGKey(4)
    key, init_key = jax.random.split(key)
    jx = haar_rotations(init_key, (B,))
    tx = _t(jx)
    step = jax.jit(lambda x, t, k: s.jproc.p_sample(s.jden, k, x, t, s.jproj))
    worst = worst_step = 0.0
    with torch.no_grad():
        for i in range(T - 1, -1, -1):
            jt = jnp.full((B,), i, jnp.int32)
            k = jax.random.fold_in(key, i)
            noise = _t(s.jproc.p_table.sample(k, jt))
            one = s.tproc.p_sample(s.tden, None, _t(jx), torch.full((B,), i), s.tproj,
                                   noise=noise)
            jx = step(jx, jt, k)
            tx = s.tproc.p_sample(s.tden, None, tx, torch.full((B,), i), s.tproj,
                                  noise=noise)
            worst_step = max(worst_step, float(np.abs(one.numpy() - np.asarray(jx)).max()))
            worst = max(worst, float(np.abs(tx.numpy() - np.asarray(jx)).max()))
    assert worst_step < 1e-4, worst_step
    assert worst < 1e-3, worst
    # the full JAX loop takes the same split/fold_in stream
    full = s.jproc.p_sample_loop(s.jden, jax.random.PRNGKey(4), (B,), s.jproj)
    _close(tx, full, 1e-3)


def test_p_sample_loop_draws_and_trajectory(s):
    """The port's own loop: one generator seeds init and noise (same seed,
    same chain), and the trajectory is indexed by timestep."""
    with torch.no_grad():
        a, traj = s.tproc.p_sample_loop(s.tden, torch.Generator().manual_seed(7), (B,),
                                        s.tproj, return_trajectory=True)
        b = s.tproc.p_sample_loop(s.tden, torch.Generator().manual_seed(7), (B,), s.tproj)
    assert traj.shape == (T, B, 3, 3)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    rtr = a @ a.transpose(-1, -2)
    _close(rtr, np.broadcast_to(np.eye(3), rtr.shape), 1e-5)


def _x_init(seed):
    """JAX's sampler init: split(key), then haar_rotations(init_key)."""
    _, init_key = jax.random.split(jax.random.PRNGKey(seed))
    return np.asarray(haar_rotations(init_key, (B,)))


def test_ddim_sample_loop(s):
    """Deterministic, 10 steps from JAX's x_init: 1e-3 (measured 2.5e-4)."""
    ref = s.jproc.ddim_sample_loop(s.jden, jax.random.PRNGKey(5), (B,), 10, s.jproj)
    with torch.no_grad():
        ours = s.tproc.ddim_sample_loop(s.tden, None, (B,), 10, s.tproj,
                                        x_init=_t(_x_init(5)))
    _close(ours, ref, 1e-3)


@pytest.mark.parametrize("method", ["flow", "euler", "heun"])
def test_pf_sample_loop(s, method):
    """Deterministic, 10 karras steps from JAX's x_init.  "flow" maps angles
    through the quantile tables, whose lerp slope amplifies the cbrt/pow ulp
    difference; the score methods go through the kernel's plain version.
    1e-3 on the rotation entries (measured 1.5e-4 to 2.3e-4)."""
    ref = s.jproc.pf_sample_loop(s.jden, jax.random.PRNGKey(6), (B,), 10, s.jproj,
                                 method=method)
    with torch.no_grad():
        ours = s.tproc.pf_sample_loop(s.tden, None, (B,), 10, s.tproj, method=method,
                                      x_init=_t(_x_init(6)))
    _close(ours, ref, 1e-3)


def test_so3_process_golden():
    """The reference's own outputs (tests/goldens/processes.npz, T = 100 with
    its betas), at the JAX package's tolerances."""
    from conftest import require_golden
    from diffusion_extensions_tpu_torch.processes.so3 import SO3Diffusion

    g = require_golden("processes.npz")
    proc = SO3Diffusion.create(100, betas=g["betas"], device="cpu")
    np.testing.assert_allclose(proc.schedule.sqrt_alphas_cumprod, g["sqrt_acp"], atol=1e-6)
    t = torch.from_numpy(g["t"]).long()
    rots, rots_noise = _t(g["rots"]), _t(g["rots_noise"])
    q = proc.q_sample(rots, t, rots_noise)
    np.testing.assert_allclose(q, g["so3_q_samp"], atol=2e-4)
    pred = proc.predict_start_from_noise(rots, t, _t(g["noise_vec"]))
    np.testing.assert_allclose(pred, g["so3_pred_x0"], atol=2e-4)
    pm, _, _ = proc.q_posterior(rots, q, t)
    np.testing.assert_allclose(pm, g["so3_post_mean"], atol=5e-4)
