"""The port's SE(3) diffusion process and samplers against the JAX package's,
on the CPU, at T = 20 with a small ProtNet (dim 32, heads 2, t_depth 2,
c_depth 3, frame_pool, cross_depth 1, rel_frame, equiv_head) behind
ProtProjection, B = 3 synthetic pairs, clip_shift 75.

Randomness is shared, never re-drawn: the port's samplers take JAX's
initial transforms (``x_init``), ``p_sample`` JAX's noise, the loss JAX's t
and noise.  The denoiser's output layer is scaled by 0.1 on both sides, to a
trained model's size: at the init's size sqrt(1/acp - 1) * v puts the x0
estimate anywhere on SO(3) and the chain is chaotic.  Rotation entries are
held to 1e-4 a step and 1e-3 a chain; shifts (up to the 75 A clip box) to
1e-4 of 1 + their size, 1e-3 for a chain.  The IGSO(3) score of the Euler
and Heun samplers goes through the kernel's plain version here.
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
from diffusion_extensions_tpu.ops import se3 as jse3
from diffusion_extensions_tpu.ops.so3 import exp_skewvec, haar_rotations, log_rmat_vec
from diffusion_extensions_tpu.processes.se3 import ProjectedSE3Diffusion as JProc
from diffusion_extensions_tpu.processes.se3 import SE3Diffusion as JSE3Diffusion
from diffusion_extensions_tpu_torch.convert import protnet_config_from_flax, protnet_params_from_flax
from diffusion_extensions_tpu_torch.data.pdb import to_device
from diffusion_extensions_tpu_torch.models.projections import ProtProjection
from diffusion_extensions_tpu_torch.models.protnet import ProtNet
from diffusion_extensions_tpu_torch.ops.se3 import AffineGrad, AffineT
from diffusion_extensions_tpu_torch.ops.so3 import log_rmat_vec as t_log_rmat_vec
from diffusion_extensions_tpu_torch.processes.se3 import ProjectedSE3Diffusion, SE3Diffusion

torch.set_num_threads(1)
T, B = 20, 3
FLAGS = dict(frame_pool=True, cross_depth=1, rel_frame=True, equiv_head=True)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _aff(j):
    return AffineT(_t(j.rot), _t(j.shift))


def _close(ours: AffineT, ref, rot_atol, shift_rtol):
    ref_shift = np.asarray(ref.shift)
    np.testing.assert_allclose(ours.rot.numpy(), np.asarray(ref.rot), atol=rot_atol, rtol=0)
    np.testing.assert_allclose(ours.shift.numpy(), ref_shift, rtol=0,
                               atol=shift_rtol * (1.0 + np.abs(ref_shift).max()))


class Setup:
    def __init__(self):
        rng = np.random.default_rng(0)
        self.batch = j_pad([j_pair(rng, 14 - 2 * i, 8 - i) for i in range(B)])
        jm = JProtNet(dim=32, heads=2, t_depth=2, c_depth=3, **FLAGS)
        params = jm.init(jax.random.PRNGKey(0), self.batch, jnp.zeros((B,), jnp.int32))
        params = jax.tree_util.tree_map(np.asarray, params)
        out = max((k for k in params["params"] if k.startswith("Dense_")),
                  key=lambda k: int(k.split("_")[1]))  # the output layer
        head = params["params"][out]
        head["kernel"], head["bias"] = head["kernel"] * 0.1, head["bias"] * 0.1
        self.jm, self.params = jm, params
        self.jden = jax.jit(lambda x, t: jm.apply(params, x, t))
        tm = ProtNet(**protnet_config_from_flax(params)).eval()
        tm.load_state_dict(protnet_params_from_flax(params))
        self.tden = tm
        self.jproc = JProc(T, clip_shift=75.0)
        self.tproc = ProjectedSE3Diffusion(T, clip_shift=75.0, device="cpu")
        self.jproj = JProj(self.batch)
        self.tbatch = to_device(self.batch, "cpu")
        self.tproj = ProtProjection(self.tbatch)
        v = rng.standard_normal((B, 3)).astype(np.float32)
        self.x = jse3.AffineT(exp_skewvec(jnp.asarray(v)),
                              jnp.asarray(rng.standard_normal((B, 3)).astype(np.float32) * 20))
        self.t = np.array([0, 7, 19], np.int32)


@pytest.fixture(scope="module")
def s():
    return Setup()


def _x_init(seed):
    """JAX's sampler init: split(key, 3), Haar rotations, unit shifts."""
    _, k_rot, k_shift = jax.random.split(jax.random.PRNGKey(seed), 3)
    return AffineT(_t(haar_rotations(k_rot, (B,))), _t(jax.random.normal(k_shift, (B, 3))))


def test_tables_and_create(s):
    for name in ("sqrt_alphas_cumprod", "sqrt_recipm1_alphas_cumprod", "posterior_mean_coef1"):
        np.testing.assert_array_equal(getattr(s.tproc.schedule, name).numpy(),
                                      np.asarray(getattr(s.jproc.schedule, name)))
    np.testing.assert_array_equal(s.tproc.q_table.inv_cdf.numpy(),
                                  np.asarray(s.jproc.q_table.inv_cdf))
    assert (s.tproc.shift_scale, s.tproc.clip_shift, s.tproc.projected) == (75.0, 75.0, True)
    with pytest.raises(ValueError, match="loss_type"):
        SE3Diffusion.create(T, loss_type="mse", device="cpu")


def test_forward_process_ops(s):
    """q_sample, predict_start_from_noise (with the shift_scale factor),
    q_posterior, q_mean_variance on shared inputs: 1e-5 on rotations,
    1e-6 relative on shifts."""
    jt, tt = jnp.asarray(s.t), torch.from_numpy(s.t).long()
    tx = _aff(s.x)
    noise = s.jproc.sample_noise(jax.random.PRNGKey(1), jt)
    tn = _aff(noise)
    _close(s.tproc.q_sample(tx, tt, tn), s.jproc.q_sample(s.x, jt, noise), 1e-5, 1e-6)
    g = np.random.default_rng(2).standard_normal((2, B, 3)).astype(np.float32) * 0.3
    jg, tg = jse3.AffineGrad(jnp.asarray(g[0]), jnp.asarray(g[1])), AffineGrad(_t(g[0]), _t(g[1]))
    xt = s.jproc.q_sample(s.x, jt, noise)
    _close(s.tproc.predict_start_from_noise(_aff(xt), tt, tg),
           s.jproc.predict_start_from_noise(xt, jt, jg), 1e-5, 1e-6)
    (pm, pv, plv), (jpm, jpv, jplv) = (s.tproc.q_posterior(tx, _aff(xt), tt),
                                       s.jproc.q_posterior(s.x, xt, jt))
    _close(pm, jpm, 1e-5, 1e-6)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jpv), rtol=1e-6)
    np.testing.assert_allclose(plv.numpy(), np.asarray(jplv), rtol=1e-6)
    (m, v, lv), (jm_, jv, jlv) = s.tproc.q_mean_variance(tx, tt), s.jproc.q_mean_variance(s.x, jt)
    _close(m, jm_, 1e-5, 1e-6)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-6)
    drawn = s.tproc.sample_noise(torch.Generator().manual_seed(0), tt)
    assert drawn.rot.shape == (B, 3, 3) and drawn.shift.shape == (B, 3)
    assert float(drawn.shift[0].abs().max()) < 75 * 0.1  # eps_0 is small


def test_p_sample_with_injected_noise(s):
    """One reverse step through the model with JAX's noise
    (rotation, unit normal z): 1e-4."""
    jt, tt = jnp.asarray(s.t), torch.from_numpy(s.t).long()
    key = jax.random.PRNGKey(3)
    k_rot, k_shift = jax.random.split(key)
    noise = AffineT(_t(s.jproc.p_table.sample(k_rot, jt)),
                    _t(jax.random.normal(k_shift, (B, 3))))
    ref = s.jproc.p_sample(s.jden, key, s.x, jt, s.jproj)
    with torch.no_grad():
        ours = s.tproc.p_sample(s.tden, None, _aff(s.x), tt, s.tproj, noise=noise)
    _close(ours, ref, 1e-4, 1e-4)


def test_ancestral_chain_step_by_step(s):
    """The whole T-step chain with JAX's keys (split(key, 3) for the init,
    fold_in(key, i) a step): each step from JAX's state within 1e-4, the
    port's own chain within 1e-3, and JAX's p_sample_loop's result."""
    key, k_rot, k_shift = jax.random.split(jax.random.PRNGKey(4), 3)
    jx = jse3.AffineT(haar_rotations(k_rot, (B,)), jax.random.normal(k_shift, (B, 3)))
    tx = _aff(jx)
    step = jax.jit(lambda x, t, k: s.jproc.p_sample(s.jden, k, x, t, s.jproj))
    with torch.no_grad():
        for i in range(T - 1, -1, -1):
            jt, tt = jnp.full((B,), i, jnp.int32), torch.full((B,), i)
            k = jax.random.fold_in(key, i)
            k_rot, k_shift = jax.random.split(k)
            noise = AffineT(_t(s.jproc.p_table.sample(k_rot, jt)),
                            _t(jax.random.normal(k_shift, (B, 3))))
            one = s.tproc.p_sample(s.tden, None, _aff(jx), tt, s.tproj, noise=noise)
            jx = step(jx, jt, k)
            _close(one, jx, 1e-4, 1e-4)
            tx = s.tproc.p_sample(s.tden, None, tx, tt, s.tproj, noise=noise)
            _close(tx, jx, 1e-3, 1e-3)
    full = s.jproc.p_sample_loop(s.jden, jax.random.PRNGKey(4), (B,), s.jproj)
    _close(tx, full, 1e-3, 1e-3)


def test_ddim_sample_loop(s):
    """10 steps from JAX's x_init: 1e-3 (measured 1.4e-4 rotation, 4.5e-5
    relative shift)."""
    ref = s.jproc.ddim_sample_loop(s.jden, jax.random.PRNGKey(5), (B,), 10, s.jproj)
    with torch.no_grad():
        ours = s.tproc.ddim_sample_loop(s.tden, None, (B,), 10, s.tproj, x_init=_x_init(5))
    _close(ours, ref, 1e-3, 1e-3)


@pytest.mark.parametrize("method", ["flow", "flow-state", "euler", "heun"])
def test_pf_sample_loop(s, method):
    """10 karras steps from JAX's x_init: 1e-3 (measured <= 1.3e-4 on
    rotations)."""
    ref = s.jproc.pf_sample_loop(s.jden, jax.random.PRNGKey(6), (B,), 10, s.jproj,
                                 method=method)
    with torch.no_grad():
        ours = s.tproc.pf_sample_loop(s.tden, None, (B,), 10, s.tproj, method=method,
                                      x_init=_x_init(6))
    _close(ours, ref, 1e-3, 1e-3)


def test_sampler_draws_its_own_init(s):
    """Without x_init one generator seeds the chain: same seed, same bits;
    samples are rotations and shifts stay in the clip box."""
    with torch.no_grad():
        a = s.tproc.ddim_sample_loop(s.tden, torch.Generator().manual_seed(7), (B,), 5, s.tproj)
        b = s.tproc.ddim_sample_loop(s.tden, torch.Generator().manual_seed(7), (B,), 5, s.tproj)
    np.testing.assert_array_equal(a.rot.numpy(), b.rot.numpy())
    rtr = a.rot @ a.rot.transpose(-1, -2)
    np.testing.assert_allclose(rtr.numpy(), np.broadcast_to(np.eye(3), rtr.shape), atol=1e-5)
    assert float(a.shift.abs().max()) <= 75.0
    with pytest.raises(ValueError, match="pf method"):
        s.tproc.pf_sample_loop(s.tden, None, (B,), 5, s.tproj, method="rk4")


def test_picard_fixed_point_is_the_port_s_ddim(s):
    """With tol 0 the Picard sampler runs S sweeps, whose fixed point is the
    sequential DDIM chain (1e-4 rotation, 1e-4 relative shift), through the
    projection's k x B tiling."""
    x0 = _x_init(8)
    with torch.no_grad():
        want = s.tproc.ddim_sample_loop(s.tden, None, (B,), 6, s.tproj, x_init=x0)
        got, k = s.tproc.parallel_sample_loop(s.tden, None, (B,), 6, tol=0.0,
                                              projection=s.tproj, return_sweeps=True,
                                              x_init=x0)
    assert k == 6
    _close(got, want, 1e-4, 1e-4)


def _synthetic_denoise(rot_log, tanh):
    """tests/test_parallel_sampler.py's SE(3) denoiser, on either side."""

    def den(x, t):
        v = rot_log(x.rot)
        tt = 0.5 + 0.1 / (1.0 + t[..., None].astype(jnp.float32)) if tanh is jnp.tanh else \
            0.5 + 0.1 / (1.0 + t[..., None].float())
        cls = jse3.AffineGrad if tanh is jnp.tanh else AffineGrad
        return cls(v * tt, 0.3 * tanh(x.shift) * tt)

    return den


def test_picard_matches_jax_unprojected():
    """JAX's parallel_sample_loop (no projection; the JAX protein
    projection cannot take its S x B call) and the port's, same x_init and
    synthetic denoiser, T 50, 10 steps: with tol 0 (10 sweeps) and with
    tol 1e-4 (the same number of sweeps, early exit), 1e-4."""
    jproc, tproc = JSE3Diffusion.create(50), SE3Diffusion.create(50, device="cpu")
    jden, tden = _synthetic_denoise(log_rmat_vec, jnp.tanh), _synthetic_denoise(
        t_log_rmat_vec, torch.tanh)
    key = jax.random.PRNGKey(4)
    _, k_rot, k_shift = jax.random.split(key, 3)
    x0 = AffineT(_t(haar_rotations(k_rot, (B,))), _t(jax.random.normal(k_shift, (B, 3))))
    for tol in (0.0, 1e-4):
        ref, jk = jproc.parallel_sample_loop(jden, key, (B,), num_steps=10, tol=tol,
                                             return_sweeps=True)
        ours, k = tproc.parallel_sample_loop(tden, None, (B,), 10, tol=tol,
                                             return_sweeps=True, x_init=x0)
        assert k == int(jk)
        _close(ours, ref, 1e-4, 1e-4)
    assert k < 10


def test_loss_with_shared_t_and_noise(s):
    """grad_mse with JAX's t and noise (as ``loss`` draws them from its key):
    rtol 1e-5."""
    key = jax.random.PRNGKey(9)
    k_t, k_n = jax.random.split(key)
    t = jax.random.randint(k_t, (B,), 0, T)
    noise = s.jproc.sample_noise(k_n, t)
    truth = jse3.AffineT(jnp.broadcast_to(jnp.eye(3), (B, 3, 3)), jnp.zeros((B, 3)))
    ref = s.jproc.loss(s.jden, key, truth, s.jproj)
    with torch.no_grad():
        ours = s.tproc.loss(s.tden, None, AffineT.identity((B,)), s.tproj,
                            t=torch.from_numpy(np.array(t)).long(), noise=_aff(noise))
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5)


def test_weight_gradients_match_jax_grad(s):
    """d loss / d weights of the dim-32 ProtNet at shared t and noise
    against ``jax.grad`` (through the converter): every entry within 1e-3
    of the model's largest gradient entry (measured 2.9e-4, in the Siren of
    the positions, whose inputs are ~30 A).  The two libraries' float32
    gradients part by up to ~4e-3 of a leaf's own largest entry in the
    ligand's cross-attention layer and the encoder below it; there the
    port's float32 gradient is within 7.5e-6 of a float64 evaluation of the
    same model, and ``test_torch_grad_x64.py`` finds the spread in JAX's
    op-by-op evaluation (``jax.grad`` without ``jit``, as here): JAX's
    jitted float32 gradient is within 1.1e-5 of float64 there."""
    key = jax.random.PRNGKey(10)
    k_t, k_n = jax.random.split(key)
    t = jax.random.randint(k_t, (B,), 0, T)
    noise = s.jproc.sample_noise(k_n, t)
    truth = jse3.AffineT(jnp.broadcast_to(jnp.eye(3), (B, 3, 3)), jnp.zeros((B, 3)))
    jgrads = jax.grad(lambda p: s.jproc.loss(lambda x, tt: s.jm.apply(p, x, tt), key, truth,
                                             s.jproj))(s.params)
    want = protnet_params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    model = ProtNet(**protnet_config_from_flax(s.params))
    model.load_state_dict(protnet_params_from_flax(s.params))
    loss = s.tproc.loss(model, None, AffineT.identity((B,)), s.tproj,
                        t=torch.from_numpy(np.array(t)).long(), noise=_aff(noise))
    loss.backward()
    scale = max(float(v.abs().max()) for v in want.values())
    assert scale > 1.0
    for name, p in model.named_parameters():
        diff = float((p.grad - want[name]).abs().max())
        assert diff <= 1e-3 * scale, (name, diff, scale)


def _double(x):
    if isinstance(x, tuple):
        return type(x)(*(_double(v) for v in x))
    return x.double() if x.is_floating_point() else x


def test_weight_gradients_match_a_float64_evaluation(s):
    """The port's float32 gradients against the same model and loss run in
    float64 (weights, batch, noise): every leaf within 2e-5 of its own
    largest entry (the key projection's bias, whose gradient is zero in
    exact arithmetic, within 1e-6 of the model's largest entry)."""
    key = jax.random.PRNGKey(10)
    k_t, k_n = jax.random.split(key)
    t = torch.from_numpy(np.array(jax.random.randint(k_t, (B,), 0, T))).long()
    noise = _aff(s.jproc.sample_noise(k_n, jnp.asarray(t.numpy())))
    grads = {}
    for dtype in (torch.float32, torch.float64):
        model = ProtNet(**protnet_config_from_flax(s.params))
        model.load_state_dict(protnet_params_from_flax(s.params))
        model = model.to(dtype)
        batch = s.tbatch if dtype == torch.float32 else _double(s.tbatch)
        nz = AffineT(noise.rot.to(dtype), noise.shift.to(dtype))
        loss = s.tproc.loss(model, None, AffineT.identity((B,), dtype=dtype),
                            ProtProjection(batch), t=t, noise=nz)
        assert loss.dtype == dtype
        loss.backward()
        grads[dtype] = {n: p.grad.double() for n, p in model.named_parameters()}
    scale = max(float(g.abs().max()) for g in grads[torch.float64].values())
    for name, g64 in grads[torch.float64].items():
        diff = float((grads[torch.float32][name] - g64).abs().max())
        tol = 1e-6 * scale if "key.bias" in name else 2e-5 * float(g64.abs().max())
        assert diff <= tol, (name, diff, float(g64.abs().max()))


def test_se3_process_golden():
    """The reference's SE(3) goldens (``se3_q_rot``, ``se3_q_shift``,
    ``se3_pred_rot``, ``se3_pred_shift`` of ``tests/goldens/processes.npz``,
    T = 100), held as ``tests/test_processes.py`` holds the JAX package:
    the reference leaves the shift_scale factor off the noise term of its
    x0 shift estimate, so its golden is corrected by (shift_scale - 1) x
    sqrt(1/acp - 1) x noise before the comparison."""
    g = np.load("tests/goldens/processes.npz")
    proc = SE3Diffusion.create(100, betas=g["betas"], device="cpu")
    t = torch.from_numpy(g["t"]).long()
    aff = AffineT(_t(g["rots"]), _t(g["shift"]))
    q = proc.q_sample(aff, t, AffineT(_t(g["rots_noise"]), _t(g["shift_n"])))
    np.testing.assert_allclose(q.rot.numpy(), g["se3_q_rot"], atol=2e-4)
    np.testing.assert_allclose(q.shift.numpy(), g["se3_q_shift"], atol=1e-5)
    pred = proc.predict_start_from_noise(aff, t, AffineGrad(_t(g["noise_vec"]), _t(g["shift_n"])))
    np.testing.assert_allclose(pred.rot.numpy(), g["se3_pred_rot"], atol=2e-4)
    ns = proc.schedule.sqrt_recipm1_alphas_cumprod.numpy()[g["t"]][:, None]
    corrected = g["se3_pred_shift"] - (proc.shift_scale - 1.0) * ns * g["shift_n"]
    np.testing.assert_allclose(pred.shift.numpy(), corrected, rtol=1e-3, atol=1e-3)
