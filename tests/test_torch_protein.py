"""The port's protein driver (``experiments/protein.py``) against the JAX
package's, on the CPU at a small size: its batches, a 10-step training
trajectory from one JAX init with JAX's t and noise, the driver end to end
(training with K = 2 and its exact tail, ``--epoch-accum``, ``--resume``,
then ``--test`` with every sampler), where its records go, and the JAX
driver's ``--sampler picard`` fault."""
import json
import os
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

from diffusion_extensions_tpu.experiments import protein as jprotein
from diffusion_extensions_tpu.models.projections import ProtProjection as JProj
from diffusion_extensions_tpu.models.protnet import ProtNet as JProtNet
from diffusion_extensions_tpu.ops import se3 as jse3
from diffusion_extensions_tpu.parallel.dp import make_dp_train_step as j_make_step
from diffusion_extensions_tpu.processes.se3 import ProjectedSE3Diffusion as JProc
from diffusion_extensions_tpu.train.optim import make_optimizer as j_make_optimizer
from diffusion_extensions_tpu.train.state import TrainState as JTrainState
from diffusion_extensions_tpu_torch.convert import protnet_config_from_flax, protnet_params_from_flax
from diffusion_extensions_tpu_torch.data.pdb import to_device
from diffusion_extensions_tpu_torch.experiments import protein
from diffusion_extensions_tpu_torch.models.projections import ProtBatch
from diffusion_extensions_tpu_torch.models.protnet import ProtNet
from diffusion_extensions_tpu_torch.parallel.dp import make_dp_train_step
from diffusion_extensions_tpu_torch.processes.se3 import ProjectedSE3Diffusion
from diffusion_extensions_tpu_torch.train.optim import make_optimizer
from diffusion_extensions_tpu_torch.train.state import TrainState, latest_step

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, B, LR, STEPS = 50, 4, 1e-3, 10
FLAGS = ["--frame-pool", "--cross-depth", "1", "--rel-frame", "--equiv-head"]
SMALL = ["--se3", "--device", "cpu", "--dim", "32", "--heads", "2", "--t_depth", "1",
         "--c_depth", "3", "--batch", "4", "--timesteps", "20", "--data-root", "/nonexistent",
         "--print-every", "1"] + FLAGS


def _equal(a, b):
    if isinstance(b, tuple):
        assert type(a).__name__ == type(b).__name__ and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("batch", [4, 5, 32])
def test_batches_are_the_jax_driver_s_bits(batch):
    """make_batches over three epochs from one seed: the same permutation,
    augmentation and padding, bit for bit (a batch above the pair count
    resamples with replacement, as in the JAX driver)."""
    args = protein.parse_args(["--se3", "--batch", str(batch)])
    pairs = protein.load_pairs(SimpleNamespace(data_root="/nonexistent"))
    jpairs = jprotein.load_pairs(SimpleNamespace(data_root="/nonexistent"))
    for p, q in zip(pairs, jpairs):
        _equal(p, q)
    rng, jrng = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(3):
        ours, ref = list(protein.make_batches(pairs, args, rng)), list(
            jprotein.make_batches(jpairs, args, jrng))
        assert len(ours) == len(ref) == max(16 // batch, 1)
        for a, b in zip(ours, ref):
            assert isinstance(a, ProtBatch)
            _equal(a, b)
    stacked = protein.stack_batches(ours + ours)
    assert stacked.ligand.angles.shape[:2] == (2 * len(ours), batch)


def _step_randomness(jproc, state_key, step: int):
    """(t, noise) of the JAX driver's train step at ``step``: the keys of
    ``parallel/dp.py`` (fold_in, split, fold_in mesh position 0), then
    ``SE3Diffusion.loss`` (split, randint, sample_noise)."""
    key = jax.random.fold_in(state_key, step)
    step_key, _ = jax.random.split(key)
    k_t, k_n = jax.random.split(jax.random.fold_in(step_key, 0))
    t = jax.random.randint(k_t, (B,), 0, T)
    noise = jproc.sample_noise(k_n, t)
    return (torch.from_numpy(np.array(t)).long(),
            (torch.from_numpy(np.array(noise.rot)), torch.from_numpy(np.array(noise.shift))))


def test_ten_step_trajectory_matches_the_jax_step():
    """The JAX driver's loss under its ``make_dp_train_step`` (one-device
    mesh) and the port's from one JAX init (dim 32, all flags), the same
    batches, t and noise, Adam lr 1e-3: every step's loss within rtol 1e-4,
    and after 10 steps every weight within lr / 10 of JAX's (measured
    1.5e-5).  The attention's key biases are held to 2 * 10 * lr only: their
    gradient is zero in exact arithmetic, so each Adam step moves them by
    ~lr in the direction of the rounding noise, which differs between the
    two libraries (measured 1.07e-2)."""
    args = jprotein.parse_args(["--se3", "--batch", str(B), "--timesteps", str(T),
                                "--dim", "32", "--heads", "2", "--t_depth", "1",
                                "--c_depth", "3", "--data-root", "/nonexistent"]
                               + FLAGS)
    pairs = jprotein.load_pairs(args)
    batches = list(jprotein.make_batches(pairs, args, np.random.default_rng(0)))
    batches += list(jprotein.make_batches(pairs, args, np.random.default_rng(1)))
    batches += list(jprotein.make_batches(pairs, args, np.random.default_rng(2)))
    jmodel, jproc = JProtNet(dim=32, heads=2, t_depth=1, c_depth=3, frame_pool=True,
                             cross_depth=1, rel_frame=True, equiv_head=True), JProc(T)
    params = jmodel.init(jax.random.PRNGKey(0), batches[0], jnp.zeros((B,), jnp.int32))
    truth = jse3.AffineT(jnp.broadcast_to(jnp.eye(3), (B, 3, 3)), jnp.zeros((B, 3)))

    def jloss(p, key, batch):
        return jproc.loss(lambda x, t: jmodel.apply(p, x, t), key, truth, projection=JProj(batch))

    tx = j_make_optimizer(LR)
    jstate = JTrainState.create(params, tx, jax.random.PRNGKey(1))
    jstep = j_make_step(jloss, tx, Mesh(np.asarray(jax.devices()[:1]), ("dp",)), donate=False)
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = ProtNet(**protnet_config_from_flax(tree))
    model.load_state_dict(protnet_params_from_flax(tree), strict=True)
    tproc = ProjectedSE3Diffusion(T, device="cpu")
    optimizer = make_optimizer(model.named_parameters(), LR)
    tstep = make_dp_train_step(protein.make_loss_fn(model, tproc), model, optimizer)
    tstate = TrainState(model, optimizer, torch.Generator())
    for i in range(STEPS):
        t, noise = _step_randomness(jproc, jstate.key, int(jstate.step))
        jstate, jm = jstep(jstate, batches[i])
        tstate, tm = tstep(tstate, (to_device(batches[i], "cpu"), t, noise))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4,
                                   err_msg=f"step {i}")
    want = protnet_params_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params))
    for name, p in model.named_parameters():
        diff = float((p.detach() - want[name]).abs().max())
        tol = 2 * STEPS * LR if "key.bias" in name else 0.1 * LR
        assert diff < tol, (name, diff)


def _read(path):
    with open(path) as f:
        return json.load(f)


def test_driver_end_to_end(tmp_path, capsys):
    """Train 5 steps with K = 2 (two calls of 2, then the exact tail of 1),
    resume to 7, an --epoch-accum run, then --test with every sampler on the
    checkpoint: the sample file lands in --out-dir, the samples are finite
    rotations, the evaluation counts are the sampler's."""
    ck, out = str(tmp_path / "ck"), str(tmp_path / "out")
    log = str(tmp_path / "log.jsonl")
    state = protein.main(SMALL + ["--steps", "5", "--steps-per-call", "2", "--ckpt", ck,
                                  "--log", log])
    assert state.step == 5 and latest_step(ck) == 5
    rows = [json.loads(line) for line in open(log)]
    assert [r["step"] for r in rows] == [2, 4, 5]
    assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in rows)
    state = protein.main(SMALL + ["--steps", "7", "--steps-per-call", "2", "--ckpt", ck,
                                  "--resume"])
    assert state.step == 7 and latest_step(ck) == 7
    acc = protein.main(SMALL + ["--steps", "3", "--epoch-accum", "--ckpt",
                                str(tmp_path / "acc")])
    assert acc.step == 1 and latest_step(str(tmp_path / "acc")) == 1  # one epoch, one step
    assert "--epoch-accum uses steps_per_call=1" in capsys.readouterr().out

    samples = protein.SAMPLES
    protein.SAMPLES = 1
    try:
        runs = {}
        for name, extra in {"ancestral": [], "ddim": ["--sampler", "ddim"],
                            "pf": ["--sampler", "pf"],
                            "heun": ["--sampler", "pf", "--pf-method", "heun"],
                            "picard": ["--sampler", "picard"]}.items():
            runs[name] = protein.main(SMALL + ["--test", "--ckpt", ck, "--out-dir", out,
                                               "--sampler-steps", "4"] + extra)
    finally:
        protein.SAMPLES = samples
    printed = capsys.readouterr().out
    assert "no checkpoint found" not in printed and "angle & " in printed
    assert {k: r["model_evals"] for k, r in runs.items()} == {
        "ancestral": 20, "ddim": 5, "pf": 5, "heun": 9, "picard": 5}
    assert runs["picard"]["sweeps"] == [4, 4, 4, 4]
    for r in runs.values():
        assert r["poses"] == 16 and r["finite"] and r["launches"] == 0  # plain version on CPU
        assert r["orth_err"] < 1e-4 and r["det_err"] < 1e-4
        assert max(r["shifts"]) <= 75 * np.sqrt(3) * (1 + 1e-6)  # the clip box
    assert sorted(os.listdir(out)) == ["torch_prot_samples_ck.json",
                                       "torch_prot_samples_ck_ddim4.json",
                                       "torch_prot_samples_ck_pf4.json",
                                       "torch_prot_samples_ck_picard4.json"]
    assert _read(os.path.join(out, "torch_prot_samples_ck_picard4.json"))["sampler"] == "picard"


def test_driver_writes_nothing_under_results(tmp_path, monkeypatch):
    """--test run from the repository root with its default --out-dir
    (torch_results/, git-ignored) leaves the committed results/ as it was."""
    results = os.path.join(ROOT, "results")
    before = {f: os.path.getmtime(os.path.join(results, f)) for f in os.listdir(results)}
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(protein, "SAMPLES", 1)
    protein.main(SMALL + ["--test", "--sampler", "ddim", "--sampler-steps", "2",
                          "--ckpt", str(tmp_path / "none")])
    assert os.listdir(tmp_path / "torch_results") == ["torch_prot_samples_none_ddim2.json"]
    after = {f: os.path.getmtime(os.path.join(results, f)) for f in os.listdir(results)}
    assert after == before


def test_euler_arm_exits_with_its_roadmap_item():
    with pytest.raises(SystemExit, match="ROADMAP.md A.2"):
        protein.main(["--device", "cpu", "--steps", "1"])
    with pytest.raises(SystemExit, match="ROADMAP.md A.2"):
        protein.main(["--device", "cpu", "--test"])


def test_training_defaults_to_the_card():
    """Without --device the driver runs on CUDA; with no card here that
    fails instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    args = protein.parse_args(["--se3"])
    assert args.device is None and args.out_dir == "torch_results"
    assert args.ckpt == "weights/protein_se3" and args.steps_per_call == 8
    with pytest.raises((RuntimeError, AssertionError)):
        protein.main(SMALL[3:] + ["--se3", "--steps", "1"])


def test_jax_driver_picard_fails_where_the_port_runs(tmp_path, monkeypatch):
    """The JAX driver's --sampler picard evaluates S x B transforms in one
    call and its ProtProjection holds only the B proteins: it raises.  The
    port's projection tiles the batch and the sampler runs."""
    monkeypatch.chdir(tmp_path)  # the JAX driver writes results/ into the cwd
    monkeypatch.setattr(jprotein, "SAMPLES", 1)
    monkeypatch.setattr(protein, "SAMPLES", 1)
    jargs = ["--se3", "--test", "--sampler", "picard", "--sampler-steps", "3", "--dim", "32",
             "--heads", "2", "--t_depth", "1", "--c_depth", "3", "--batch", "2",
             "--timesteps", "20", "--data-root", "/nonexistent", "--ckpt",
             str(tmp_path / "none")]
    with pytest.raises(Exception, match="[Ii]ncompatible shapes|shape"):
        jprotein.main(jargs)
    rec = protein.main(jargs + ["--device", "cpu", "--out-dir", str(tmp_path / "out")])
    assert rec["finite"] and rec["poses"] == 16 and rec["sweeps"] == [3] * 8
