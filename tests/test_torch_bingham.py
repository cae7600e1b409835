"""The port's Bingham evaluation slice against the JAX package's, on the CPU:
the quaternion/6D/SVD geometry, the Bingham target, the Picard sampler, and
the slice as a whole (converted RotPredict weights, a shared x_init, the
DDIM-10 chain and the MMD of its samples), then the driver end to end.

Randomness is shared, never re-drawn: the port's Bingham transforms JAX's
normal draws (``Bingham.from_normal``), and its samplers start from JAX's
initial rotations (``x_init``).
"""
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffusion_extensions_tpu.data.synthetic import BINGHAM_COVS as J_COVS
from diffusion_extensions_tpu.data.synthetic import bingham_dist as j_bingham_dist
from diffusion_extensions_tpu.models.rot_predict import RotPredict as JRotPredict
from diffusion_extensions_tpu.ops import metrics as jm
from diffusion_extensions_tpu.ops import so3 as jso3
from diffusion_extensions_tpu.processes.so3 import SO3Diffusion as JSO3Diffusion
from diffusion_extensions_tpu_torch.convert import rot_predict_params_from_flax
from diffusion_extensions_tpu_torch.data.synthetic import BINGHAM_COVS, bingham_dist
from diffusion_extensions_tpu_torch.experiments import bingham
from diffusion_extensions_tpu_torch.models.rot_predict import RotPredict
from diffusion_extensions_tpu_torch.ops import metrics as tm
from diffusion_extensions_tpu_torch.ops import so3 as tso3
from diffusion_extensions_tpu_torch.processes.so3 import SO3Diffusion, prefix_products

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol)


# -- geometry ------------------------------------------------------------

def test_quat_to_rmat_matches_jax_unit_and_not():
    q = np.random.default_rng(0).standard_normal((64, 4)).astype(np.float32) * 3.0
    q[0] = [1.0, 0.0, 0.0, 0.0]
    q[1] = [0.0, 1.0, 0.0, 0.0]  # rotation by pi about x
    ref = np.asarray(jso3.quat_to_rmat(jnp.asarray(q)))
    ours = tso3.quat_to_rmat(_t(q)).numpy()
    _close(ours, ref, 1e-6)
    _close(ours[0], np.eye(3), 0)
    _close(ours[1], np.diag([1.0, -1.0, -1.0]), 1e-7)


def test_six_d_roundtrip_matches_jax():
    x = np.random.default_rng(1).standard_normal((64, 6)).astype(np.float32)
    ref = np.asarray(jso3.six2rmat(jnp.asarray(x)))
    ours = tso3.six2rmat(_t(x))
    _close(ours, ref, 1e-6)
    _close(tso3.rmat2six(ours), np.asarray(jso3.rmat2six(jnp.asarray(ref))), 0)
    _close(tso3.six2rmat(tso3.rmat2six(ours)), ours, 1e-6)


def test_orthogonalise_matches_jax():
    """Rotations perturbed off SO(3) map back to the same rotation; a 3x4
    input keeps its fourth column."""
    rng = np.random.default_rng(2)
    r = np.array(jso3.exp_skewvec(jnp.asarray(rng.standard_normal((32, 3)).astype(np.float32))))
    noisy = (r + 1e-3 * rng.standard_normal(r.shape)).astype(np.float32)
    ref = np.asarray(jso3.orthogonalise(jnp.asarray(noisy)))
    ours = tso3.orthogonalise(_t(noisy)).numpy()
    _close(ours, ref, 1e-6)
    _close(np.swapaxes(ours, -1, -2) @ ours, np.broadcast_to(np.eye(3), ours.shape), 1e-6)
    aff = np.concatenate([noisy, rng.standard_normal((32, 3, 1)).astype(np.float32)], -1)
    ours_aff = tso3.orthogonalise(_t(aff)).numpy()
    _close(ours_aff, np.asarray(jso3.orthogonalise(jnp.asarray(aff))), 1e-6)
    _close(ours_aff[..., 3], aff[..., 3], 0)


# -- Bingham target --------------------------------------------------------

@pytest.mark.parametrize("cov", sorted(J_COVS))
def test_bingham_from_shared_normal_draws(cov):
    """The presets equal JAX's; JAX's own normal draws through the port's
    transform give JAX's samples."""
    np.testing.assert_array_equal(BINGHAM_COVS[cov], J_COVS[cov])
    jd, td = j_bingham_dist(cov), bingham_dist(cov, device="cpu")
    _close(td.scale_tril, jd.scale_tril, 1e-6 * float(np.abs(jd.scale_tril).max()))
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jd.sample(key, (512,)))
    z = np.asarray(jax.random.normal(key, (512, 4), dtype=jnp.float32))
    ours = td.from_normal(_t(z)).numpy()
    _close(ours, ref, 1e-6)
    _close(tso3.quat_to_rmat(_t(ours)), jso3.quat_to_rmat(jnp.asarray(ref)), 1e-6)


def test_bingham_sampler_distribution():
    """tests/test_igso3.py's check: unit norms, dominated by the first
    component for the small uncorrelated preset; and a generator seeds it."""
    d = bingham_dist("sur", device="cpu")
    q = d.sample(torch.Generator().manual_seed(5), (4096,))
    np.testing.assert_allclose(torch.linalg.norm(q, dim=-1).numpy(), 1.0, atol=1e-5)
    assert float(q[:, 0].abs().mean()) > 0.95
    again = d.sample(torch.Generator().manual_seed(5), (4096,))
    assert torch.equal(q, again)


# -- Picard sampler --------------------------------------------------------

B, STEPS = 8, 10


def _toy_denoise(x, t):
    """Deterministic smooth stand-in for a trained model (as in
    tests/test_parallel_sampler.py)."""
    v = tso3.log_rmat_vec(x)
    return v * (0.5 + 0.1 / (1.0 + t[..., None].float()))


@pytest.fixture(scope="module")
def proc():
    return SO3Diffusion.create(50, device="cpu")


def test_prefix_products_match_sequential_loop():
    r = _t(jso3.exp_skewvec(jnp.asarray(
        np.random.default_rng(4).standard_normal((13, 5, 3)).astype(np.float32))))
    want = [r[0]]
    for i in range(1, 13):
        want.append(want[-1] @ r[i])
    _close(prefix_products(r), torch.stack(want), 1e-5)


@pytest.mark.parametrize("method", ["ddim", "flow"])
def test_parallel_matches_sequential(proc, method):
    """tol = 0 runs all S sweeps and lands on the sequential chain."""
    g = torch.Generator().manual_seed(0)
    x_init = tso3.haar_rotations(g, (B,))
    x_init = x_init * torch.linalg.det(x_init)[:, None, None]  # proper rotations
    if method == "ddim":
        want = proc.ddim_sample_loop(_toy_denoise, None, (B,), STEPS, x_init=x_init)
    else:
        want = proc.pf_sample_loop(_toy_denoise, None, (B,), STEPS, method="flow",
                                   x_init=x_init)
    got, k = proc.parallel_sample_loop(_toy_denoise, None, (B,), num_steps=STEPS,
                                       method=method, tol=0.0, return_sweeps=True,
                                       x_init=x_init)
    assert k == STEPS
    _close(got, want, 1e-4)


def test_parallel_converges_in_fewer_sweeps(proc):
    g = torch.Generator().manual_seed(1)
    want = proc.ddim_sample_loop(_toy_denoise, g, (B,), STEPS)
    g = torch.Generator().manual_seed(1)
    got, k = proc.parallel_sample_loop(_toy_denoise, g, (B,), num_steps=STEPS, tol=1e-4,
                                       return_sweeps=True)
    assert k < STEPS, f"no parallel speedup: {k} sweeps for {STEPS}"
    _close(got, want, 1e-3)


def test_parallel_matches_jax_from_shared_init(proc):
    """The port's Picard sweep against JAX's, same init, same toy model,
    same number of sweeps; 1e-3 on the rotation entries (see
    ``test_slice_ddim_chain_and_mmd_match_jax`` for why not 1e-4)."""
    jproc = JSO3Diffusion.create(timesteps=50)
    key = jax.random.PRNGKey(2)
    _, init_key = jax.random.split(key)
    x0 = np.asarray(jproc.prior_table.sample(init_key, jnp.zeros((B,), jnp.int32)))

    def jden(x, t):
        return jso3.log_rmat_vec(x) * (0.5 + 0.1 / (1.0 + t[..., None].astype(jnp.float32)))

    for method in ("ddim", "flow"):
        ref, jk = jproc.parallel_sample_loop(jden, key, (B,), num_steps=STEPS, method=method,
                                             tol=1e-4, return_sweeps=True)
        ours, k = proc.parallel_sample_loop(_toy_denoise, None, (B,), num_steps=STEPS,
                                            method=method, tol=1e-4, return_sweeps=True,
                                            x_init=_t(x0))
        assert k == int(jk)
        _close(ours, ref, 1e-3)


# -- the slice as a whole ---------------------------------------------------

T, N_CHAINS = 50, 256


@pytest.fixture(scope="module")
def slice_setup():
    """Converted d65 RotPredict weights with the head scaled by 0.1 (a
    trained model's size: at the random init's, sqrt(1/acp - 1) * v reaches
    hundreds of radians near t = T - 1, and log near pi makes two float32
    runs of the chain part), JAX's prior init and Bingham targets."""
    jmodel = JRotPredict(d_model=65, out_type="skewvec")
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 3)), jnp.zeros((1,), jnp.int32))
    params = jax.tree_util.tree_map(np.array, params)
    head = params["params"]["Dense_4"]
    head["kernel"], head["bias"] = head["kernel"] * 0.1, head["bias"] * 0.1
    tmodel = RotPredict(65, "skewvec").eval()
    tmodel.load_state_dict(rot_predict_params_from_flax(params))
    jproc = JSO3Diffusion.create(T)
    key = jax.random.PRNGKey(7)
    _, init_key = jax.random.split(key)
    x_init = np.asarray(jproc.prior_table.sample(init_key, jnp.zeros((N_CHAINS,), jnp.int32)))
    z = np.random.default_rng(8).standard_normal((N_CHAINS, 4)).astype(np.float32)
    target = tso3.quat_to_rmat(bingham_dist("lcr", device="cpu").from_normal(_t(z)))
    return dict(jmodel=jmodel, params=params, tmodel=tmodel, jproc=jproc, key=key,
                x_init=x_init, target=target.numpy())


def test_slice_ddim_chain_and_mmd_match_jax(slice_setup):
    """DDIM-10 at T = 50 over 256 chains, then each package's MMD of its
    samples against the same targets (rtol 1e-3).

    At T = 50 the first step's x0 estimate is so3_scale(x_49, 1014.7)
    (sqrt(1 / acp_49)): it multiplies log(x_49), whose float32 value differs
    by an ulp or two between the packages' math libraries, by ~1000, with
    any model (the head's scale does not change it).  So each step taken
    from JAX's own state agrees to 2e-4 (measured 1.3e-4, at t = 49), and
    the whole chain run on its own to 1e-3 (measured 4.2e-4)."""
    s = slice_setup
    jden = jax.jit(lambda x, t: s["jmodel"].apply(s["params"], x, t))
    proc = SO3Diffusion.create(T, device="cpu")
    ts = np.round(np.linspace(T - 1, 0, 11)).astype(np.int32)
    assert ts.tolist() == [int(v) for v in torch.linspace(T - 1, 0, 11).round()]
    jx = jnp.asarray(s["x_init"])
    worst_step = 0.0
    with torch.no_grad():
        for i in range(10):
            t, tp = (np.full((N_CHAINS,), v, np.int32) for v in (ts[i], ts[i + 1]))
            one = proc._ddim_map(s["tmodel"], _t(jx), torch.from_numpy(t).long(),
                                 torch.from_numpy(tp).long())
            jx = s["jproc"]._ddim_map(jden, jx, jnp.asarray(t), jnp.asarray(tp))
            worst_step = max(worst_step, float(np.abs(one.numpy() - np.asarray(jx)).max()))
    assert worst_step < 2e-4, worst_step

    ref = s["jproc"].ddim_sample_loop(jden, s["key"], (N_CHAINS,), num_steps=10)
    with torch.no_grad():
        ours = proc.ddim_sample_loop(s["tmodel"], None, (N_CHAINS,), 10, x_init=_t(s["x_init"]))
    _close(ours, ref, 1e-3)
    ref_mmd = float(jm.mmd(jnp.asarray(s["target"]), ref, jm.gaussian_kernel_matrix,
                           chunksize=100))
    ours_mmd = float(tm.mmd(_t(s["target"]), ours, tm.gaussian_kernel_matrix, chunksize=100))
    np.testing.assert_allclose(ours_mmd, ref_mmd, rtol=1e-3)


def test_bingham_driver_end_to_end(tmp_path, monkeypatch):
    """``main([..., "--test", "--sampler-ab"])`` on the CPU at a small size:
    every row, its record fields and launch counts, and files written only
    under --out-dir (nothing in the repo's results/)."""
    monkeypatch.setattr(bingham, "SAMPLES", 96)
    monkeypatch.setattr(bingham, "NET_SAMPLES", 48)
    monkeypatch.setattr(bingham, "MMD_CHUNK", 40)
    results_dir = os.path.join(ROOT, "results")
    before = {f: os.path.getmtime(os.path.join(results_dir, f)) for f in os.listdir(results_dir)}
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "out"
    got = bingham.main(["lcr", "--test", "--sampler-ab", "--timesteps", "20",
                        "--device", "cpu", "--out-dir", str(out),
                        "--ckpt", str(tmp_path / "missing.pt")])
    recs = got["lcr"]
    assert [r["sampler"] for r in recs] == [
        "ancestral_1000", "ddim_50", "ddim_20", "pf_flow_50", "pf_flow_10",
        "pf_heun_25_karras", "pf_euler_50_karras", "ddim_50_picard"]
    for r in recs:
        assert {"cov", "sampler", "mmd", "count", "accept_threshold", "passes",
                "sample_seconds"} <= set(r)
        assert r["count"] == 96 and np.isfinite(r["mmd"])
        assert r["orth_err"] < 1e-4 and r["det_err"] < 1e-4
        # the CPU takes the plain versions: no kernel launches
        assert r["launches"] == {"igso3_logpdf_score": 0, "gaussian_kernel_sum": 0}
    evals = {r["sampler"]: r["model_evals"] for r in recs}
    assert evals["ancestral_1000"] == 2 * 20  # two chains of NET_SAMPLES
    assert evals["ddim_20"] == 2 * 21 and evals["pf_heun_25_karras"] == 2 * 51
    assert 1 <= recs[-1]["sweeps"] <= 50
    assert sorted(os.listdir(tmp_path)) == ["out"]
    assert sorted(os.listdir(out)) == ["torch_bingham_mmd_lcr.json",
                                       "torch_bingham_sampler_ab_lcr.json"]
    with open(out / "torch_bingham_sampler_ab_lcr.json") as f:
        assert [r["sampler"] for r in json.load(f)] == [r["sampler"] for r in recs]
    after = {f: os.path.getmtime(os.path.join(results_dir, f)) for f in os.listdir(results_dir)}
    assert after == before


def test_bingham_driver_without_test_flag_exits():
    """Without ``--test`` ``main`` trains, on the card unless ``--device``
    says otherwise: with no card it raises, it does not move to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    with pytest.raises((RuntimeError, AssertionError)):
        bingham.main(["lcr", "--steps", "1"])
