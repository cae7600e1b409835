"""The Euler arms of the port's aircraft and protein drivers (``--so3`` /
``--se3`` off) against the JAX drivers, on the CPU at small sizes: each
arm's loss against the JAX driver's on the same batch with JAX's t and
noise, the aircraft arm's frozen probe against the JAX driver's formula,
and each driver end to end (``train()`` then ``--test``, the aircraft arm
with ``--euler-init haar`` and ``marginal``), the committed ``results/``
untouched."""
import hashlib
import json
import os
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import torch

from diffusion_extensions_tpu.experiments import aircraft as jaircraft
from diffusion_extensions_tpu.experiments import protein as jprotein
from diffusion_extensions_tpu.models.projections import PointCloudProj as JCloudProj
from diffusion_extensions_tpu.models.projections import ProtProjection as JProtProj
from diffusion_extensions_tpu_torch.convert import (
    planenet_params_from_flax,
    protnet_config_from_flax,
    protnet_params_from_flax,
)
from diffusion_extensions_tpu_torch.data.pdb import to_device
from diffusion_extensions_tpu_torch.experiments import aircraft, protein
from diffusion_extensions_tpu_torch.processes.euler import ProjectedEulerDiffusion
from diffusion_extensions_tpu_torch.processes.r3 import GaussianDiffusion
from diffusion_extensions_tpu_torch.train.state import latest_step

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AIR = ["--device", "cpu", "--dim", "32", "--heads", "2", "--layers", "1", "--batch", "8",
       "--samples", "16", "--timesteps", "50", "--data-root", "/nonexistent", "--no-native"]
PROT = ["--device", "cpu", "--dim", "32", "--heads", "2", "--t_depth", "1", "--c_depth", "3",
        "--batch", "4", "--timesteps", "20", "--data-root", "/nonexistent", "--frame-pool",
        "--cross-depth", "1", "--rel-frame", "--equiv-head"]


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _hashes(d: str) -> dict:
    out = {}
    for base, _, files in os.walk(os.path.join(ROOT, d)):
        for f in files:
            with open(os.path.join(base, f), "rb") as fh:
                out[os.path.join(base, f)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _rn_draws(key, b: int, T: int, width: int):
    """t and the standard normal noise of ``GaussianDiffusion.loss``."""
    k_t, k_n = jax.random.split(key)
    t = jax.random.randint(k_t, (b,), 0, T)
    return torch.from_numpy(np.array(t)).long(), _t(jax.random.normal(k_n, (b, width)))


def test_aircraft_euler_loss_matches_the_jax_driver():
    """``aircraft.make_loss_fn(so3=False)`` (l1 of ProjectedGaussianDiffusion
    on zero Euler angles through the Euler ``PointCloudProj``) against the
    JAX driver's ``make_loss_fn(..., so3=False)`` on one batch with its t
    and noise: rtol 1e-5."""
    jargs = jaircraft.parse_args(["--dim", "32", "--heads", "2", "--layers", "1", "--batch",
                                  "8", "--timesteps", "50"])
    jmodel, jproc, truepos = jaircraft.build(jargs)
    clouds = np.random.default_rng(0).standard_normal((8, 16, 3)).astype(np.float32)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(clouds), jnp.zeros((8,), jnp.int32))
    key = jax.random.PRNGKey(1)
    ref = jaircraft.make_loss_fn(jmodel, jproc, truepos, so3=False)(params, key,
                                                                    jnp.asarray(clouds))
    args = aircraft.parse_args(AIR)
    model, proc = aircraft.build(args, torch.device("cpu"))
    assert isinstance(proc, GaussianDiffusion)
    assert (proc.loss_type, proc.clip_denoised_default) == ("l1", False)
    model.load_state_dict(planenet_params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    t, noise = _rn_draws(key, 8, 50, 3)
    with torch.no_grad():
        ours = aircraft.make_loss_fn(model, proc, so3=False)(None, (_t(clouds), t, noise))
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5)


def test_aircraft_euler_probe_matches_the_jax_formula():
    """The Euler arm's frozen probe: MSE of the model on the noisy zero
    state through the Euler projection against the noise itself
    (``aircraft.py:196-204`` of the JAX driver), from JAX's t_v and
    noise_v: rtol 1e-5."""
    jargs = jaircraft.parse_args(["--dim", "32", "--heads", "2", "--layers", "1", "--batch",
                                  "8", "--timesteps", "50"])
    jmodel, jproc, truepos = jaircraft.build(jargs)
    clouds = np.random.default_rng(2).standard_normal((8, 16, 3)).astype(np.float32)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(clouds), jnp.zeros((8,), jnp.int32))
    t_v = jax.random.randint(jax.random.PRNGKey(7), (8,), 0, 50)
    noise_v = jax.random.normal(jax.random.PRNGKey(8), (8, 3))
    x_in = JCloudProj(jnp.asarray(clouds), so3=False)(jproc.q_sample(truepos, t_v, noise_v))
    ref = jnp.mean((jmodel.apply(params, x_in, t_v) - noise_v) ** 2)
    model, proc = aircraft.build(aircraft.parse_args(AIR), torch.device("cpu"))
    model.load_state_dict(planenet_params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    probe = aircraft.make_val_probe(model, proc, _t(clouds), torch.from_numpy(np.array(t_v)).long(),
                                    _t(noise_v), so3=False)
    np.testing.assert_allclose(float(probe()), float(ref), rtol=1e-5)


def test_aircraft_euler_arm_end_to_end(tmp_path, capsys):
    """Train 12 steps at K = 4, then ``--test`` with each ``--euler-init``
    (one chain a shape; --max-shapes 10 stops after the second batch of 8):
    angle errors in [0, pi], the arm's label and file, the seeded chain
    reproducible, results/ untouched."""
    before = _hashes("results")
    ck = str(tmp_path / "eul" / "ck")
    state = aircraft.main(AIR + ["--steps", "12", "--steps-per-call", "4", "--ckpt", ck,
                                 "--log", str(tmp_path / "log.jsonl"), "--print-every", "4"])
    assert state.step == 12 and latest_step(ck) == 12
    with open(tmp_path / "log.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [4, 8, 12]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["test_loss"]) for r in rows)
    capsys.readouterr()
    per_shape = aircraft.SAMPLES_PER_SHAPE
    aircraft.SAMPLES_PER_SHAPE = 1
    try:
        for init, label in (("haar", "eul"), ("marginal", "eul_marginal")):
            res = aircraft.main(AIR + ["--test", "--euler-init", init, "--ckpt", ck,
                                       "--max-shapes", "10"])
            again = aircraft.main(AIR + ["--test", "--euler-init", init, "--ckpt", ck,
                                         "--max-shapes", "10"])
            out = capsys.readouterr().out
            assert "no checkpoint found" not in out and f"samples ({label})" in out
            assert res.shape == (16,) and np.isfinite(res).all()
            assert float(res.min()) >= 0.0 and float(res.max()) <= np.pi + 1e-5
            np.testing.assert_array_equal(res, again)
            np.testing.assert_array_equal(
                np.load(tmp_path / "eul" / f"results_aircraft_{label}.npy"), res)
    finally:
        aircraft.SAMPLES_PER_SHAPE = per_shape
    assert _hashes("results") == before


def test_protein_euler_loss_matches_the_jax_driver():
    """``protein.make_loss_fn(se3=False)`` (grad_mse of
    ProjectedEulerDiffusion on the zero 6-vector through the Euler
    ``ProtProjection``) against the JAX driver's loss (its ``build`` and
    ``true_pos_for``, ``process.loss`` through ``ProtProjection(se3=False)``)
    on one batch with its t and noise, ProtNet(se3=False) dim 32 with the
    flags: rtol 1e-5."""
    jargs = jprotein.parse_args(PROT[2:])
    jmodel, jproc = jprotein.build(jargs)
    pairs = jprotein.load_pairs(SimpleNamespace(data_root="/nonexistent"))
    batch = next(jprotein.make_batches(pairs, jargs, np.random.default_rng(0)))
    params = jmodel.init(jax.random.PRNGKey(0), batch, jnp.zeros((4,), jnp.int32))
    key = jax.random.PRNGKey(3)
    ref = jproc.loss(lambda x, t: jmodel.apply(params, x, t), key,
                     jprotein.true_pos_for(jargs, 4), projection=JProtProj(batch, se3=False))
    args = protein.parse_args(PROT)
    model, proc = protein.build(args, torch.device("cpu"))
    assert isinstance(proc, ProjectedEulerDiffusion) and not model.se3
    tree = jax.tree_util.tree_map(np.asarray, params)
    assert {k: v for k, v in protnet_config_from_flax(tree).items()
            if k not in ("fused_qkv", "share_encoders")} == dict(
        dim=32, heads=2, t_depth=1, c_depth=3, frame_pool=True, cross_depth=1, rel_frame=True,
        equiv_head=True)
    model.load_state_dict(protnet_params_from_flax(tree))
    t, noise = _rn_draws(key, 4, 20, 6)
    with torch.no_grad():
        ours = protein.make_loss_fn(model, proc, se3=False)(None, (to_device(batch, "cpu"), t,
                                                                   noise))
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5)


def test_protein_euler_arm_end_to_end(tmp_path, monkeypatch, capsys):
    """Train 6 steps at K = 2, then ``--test`` (the ancestral chain whatever
    ``--sampler`` says, as the JAX driver): rotations decoded from Euler
    angles, finite shifts, the record in ``--out-dir``, results/ and the
    cwd untouched."""
    before = _hashes("results")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(protein, "SAMPLES", 1)
    ck, out = str(tmp_path / "ck"), str(tmp_path / "out")
    state = protein.main(PROT + ["--steps", "6", "--steps-per-call", "2", "--ckpt", ck,
                                 "--print-every", "2", "--log", str(tmp_path / "log.jsonl")])
    assert state.step == 6 and latest_step(ck) == 6
    rec = protein.main(PROT + ["--test", "--sampler", "ddim", "--ckpt", ck, "--out-dir", out])
    text = capsys.readouterr().out
    assert "applies to --se3 only" in text and "16 samples (eul)" in text
    assert (rec["arm"], rec["sampler"], rec["model_evals"], rec["launches"]) == (
        "eul", "ancestral", 20, 0)
    assert rec["finite"] and rec["orth_err"] < 1e-5 and rec["det_err"] < 1e-5
    assert os.listdir(out) == ["torch_prot_samples_ck.json"]
    assert sorted(os.listdir(tmp_path)) == ["ck", "log.jsonl", "out"]
    assert _hashes("results") == before
