"""The port's so3_toy driver against the JAX package's, on the CPU: the
two-mode target (equal modes; the batch sampler by its indices and by its
distribution), a 10-step train trajectory against the JAX driver's step
(its loss and optax Adam under ``make_dp_train_step`` on a one-device mesh,
the port fed JAX's t and noise), the driver end to end at a small size
(train, resume, ``--test`` with each sampler), and the committed
``results/`` and ``images/`` untouched."""
import hashlib
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from jax.sharding import Mesh

from diffusion_extensions_tpu.data import synthetic as jsynthetic
from diffusion_extensions_tpu.experiments import so3_toy as jtoy
from diffusion_extensions_tpu.parallel.dp import make_dp_train_step as j_make_step
from diffusion_extensions_tpu.train.state import TrainState as JTrainState
from diffusion_extensions_tpu_torch.convert import rot_predict_params_from_flax
from diffusion_extensions_tpu_torch.data.synthetic import sample_two_mode_batch, two_mode_rotations
from diffusion_extensions_tpu_torch.experiments import so3_toy
from diffusion_extensions_tpu_torch.parallel.dp import make_dp_train_step
from diffusion_extensions_tpu_torch.train.optim import make_optimizer
from diffusion_extensions_tpu_torch.train.state import TrainState, latest_step

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, B, LR, STEPS = 100, 8, 1e-3, 10


def tree_hashes(*dirs) -> dict:
    """sha256 of every file under the repository's ``dirs``."""
    out = {}
    for d in dirs:
        for base, _, files in os.walk(os.path.join(ROOT, d)):
            for f in files:
                path = os.path.join(base, f)
                with open(path, "rb") as fh:
                    out[os.path.relpath(path, ROOT)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_two_mode_rotations_match_jax():
    np.testing.assert_array_equal(two_mode_rotations().numpy(),
                                  np.asarray(jsynthetic.two_mode_rotations()))


def test_two_mode_batch_by_indices_and_distribution():
    """Every row is exactly one of the modes; the JAX sampler's draws index
    the same table; 8192 draws put 50% +- 2% on each mode, as JAX's do."""
    modes = two_mode_rotations()
    idx = np.array(jax.random.randint(jax.random.PRNGKey(0), (64,), 0, 2))
    np.testing.assert_array_equal(modes[torch.from_numpy(idx)].numpy(),
                                  np.asarray(jsynthetic.sample_two_mode_batch(
                                      jax.random.PRNGKey(0), 64)))
    ours = sample_two_mode_batch(torch.Generator().manual_seed(0), 8192)
    is0 = (ours == modes[0]).flatten(1).all(1)
    is1 = (ours == modes[1]).flatten(1).all(1)
    assert bool((is0 ^ is1).all())
    ref = np.asarray(jsynthetic.sample_two_mode_batch(jax.random.PRNGKey(1), 8192))
    for frac in (float(is0.float().mean()), float((ref == np.asarray(modes[0])).all((1, 2)).mean())):
        assert abs(frac - 0.5) < 0.02


def _step_randomness(jproc, state_key, step: int):
    """(t, noise) of the JAX step at ``step`` (``parallel/dp.py``'s keys,
    mesh position 0, then ``SO3Diffusion.loss``'s split)."""
    key = jax.random.fold_in(state_key, step)
    step_key, _ = jax.random.split(key)
    k_t, k_n = jax.random.split(jax.random.fold_in(step_key, 0))
    t = jax.random.randint(k_t, (B,), 0, T)
    return (torch.from_numpy(np.array(t)).long(),
            torch.from_numpy(np.array(jproc.sample_noise(k_n, t))))


def test_ten_step_trajectory_matches_the_jax_step():
    """The JAX driver's model, loss and ``optax.adam`` under its
    ``make_dp_train_step`` and the port's from one JAX init, the same
    batches, t and noise, lr 1e-3: every loss rtol 1e-4, every weight after
    10 steps within lr / 10 of JAX's."""
    jargs = jtoy.parse_args(["--timesteps", str(T), "--batch", str(B), "--lr", str(LR)])
    jmodel, jproc = jtoy.build(jargs)
    batches = [np.asarray(jsynthetic.sample_two_mode_batch(jax.random.PRNGKey(100 + i), B))
               for i in range(STEPS)]
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(batches[0]),
                         jnp.zeros((B,), jnp.int32))
    tx = optax.adam(LR)
    jstate = JTrainState.create(params, tx, jax.random.PRNGKey(1))
    jstep = j_make_step(lambda p, k, b: jproc.loss(lambda x, t: jmodel.apply(p, x, t), k, b),
                        tx, Mesh(np.asarray(jax.devices()[:1]), ("dp",)), donate=False)
    args = so3_toy.parse_args(["--timesteps", str(T), "--device", "cpu"])
    model, proc = so3_toy.build(args, torch.device("cpu"))
    model.load_state_dict(rot_predict_params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    optimizer = make_optimizer(model.named_parameters(), LR)
    tstep = make_dp_train_step(so3_toy.make_loss_fn(model, proc), model, optimizer)
    tstate = TrainState(model, optimizer, torch.Generator())
    for i in range(STEPS):
        t, noise = _step_randomness(jproc, jstate.key, int(jstate.step))
        jstate, jm = jstep(jstate, jnp.asarray(batches[i]))
        tstate, tm = tstep(tstate, (torch.from_numpy(batches[i]), t, noise))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4,
                                   err_msg=f"step {i}")
    want = rot_predict_params_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params))
    for name, p in model.named_parameters():
        assert float((p.detach() - want[name]).abs().max()) < LR / 10, name


@pytest.fixture()
def small(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return ["--device", "cpu", "--timesteps", "20", "--batch", "16"]


def test_driver_end_to_end(small, tmp_path, capsys):
    """Train 40 steps at K = 16 (calls of 16, 16 and the exact tail of 8),
    resume to 56, then ``--test`` with each sampler on the checkpoint: the
    records land in ``--out-dir``, nothing else is written, and the
    repository's results/ and images/ keep their bytes."""
    before = tree_hashes("results", "images")
    ck, log, out = str(tmp_path / "ck"), str(tmp_path / "log.jsonl"), str(tmp_path / "out")
    state = so3_toy.main(small + ["--steps", "40", "--ckpt", ck, "--log", log,
                                  "--print-every", "16", "--ckpt-every", "32"])
    assert state.step == 40 and latest_step(ck) == 40
    with open(log) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [16, 32, 40]
    assert all(np.isfinite(r["loss"]) for r in rows)
    state = so3_toy.main(small + ["--steps", "56", "--ckpt", ck, "--resume"])
    assert state.step == 56 and latest_step(ck) == 56
    for sampler, evals in (("ancestral", 20), ("ddim", 5), ("pf", 5)):
        rec = so3_toy.main(small + ["--test", "--sampler", sampler, "--sampler-steps", "5",
                                    "--eval-batch", "24", "--ckpt", ck, "--out-dir", out])
        text = capsys.readouterr().out
        assert "untrained" not in text and "angle-to-nearest-mode percentiles" in text
        assert rec["model_evals"] == evals and rec["launches"] == 0 and rec["finite"]
        assert len(rec["angles"]) == 24 and 0.0 <= min(rec["angles"]) <= max(rec["angles"]) <= np.pi
        with open(os.path.join(out, f"torch_so3_toy_{sampler}.json")) as f:
            assert json.load(f)["percentiles"] == rec["percentiles"]
    assert sorted(os.listdir(tmp_path)) == ["ck", "log.jsonl", "out"]
    assert tree_hashes("results", "images") == before


def test_plot_is_not_ported_yet(small, tmp_path):
    """``--plot`` is ported now: ``--test --plot`` traces the ancestral
    chain's Euler angles into ``<out-dir>/torch_so3_toy_traces.png`` (or the
    path it is given), beside the record, and takes no other sampler."""
    out = str(tmp_path / "out")
    rec = so3_toy.main(small + ["--test", "--plot", "--eval-batch", "8", "--out-dir", out])
    assert rec["sampler"] == "ancestral" and rec["model_evals"] == 20
    assert sorted(os.listdir(out)) == ["torch_so3_toy_ancestral.json",
                                       "torch_so3_toy_traces.png"]
    assert os.path.getsize(os.path.join(out, "torch_so3_toy_traces.png")) > 1000
    path = str(tmp_path / "fig" / "t.png")
    so3_toy.main(small + ["--test", "--plot", path, "--eval-batch", "8", "--out-dir", out])
    assert os.path.getsize(path) > 1000
    with pytest.raises(SystemExit):
        so3_toy.main(small + ["--test", "--plot", "--sampler", "ddim"])


def test_the_driver_defaults_to_the_card(small):
    """Without ``--device`` the driver runs on CUDA; with no card here it
    fails instead of moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        so3_toy.main(["--steps", "1", "--timesteps", "20"])


JAX_FLAGS = ["batch", "lr", "steps", "d_model", "timesteps", "seed", "ckpt", "ckpt_every",
             "print_every", "log", "resume", "debug_nans", "test", "sampler", "sampler_steps",
             "eval_batch", "plot"]


@pytest.mark.parametrize("name", JAX_FLAGS)
def test_parser_option_matches_the_jax_drivers(name):
    ref, ours = vars(jtoy.parse_args([])), vars(so3_toy.parse_args([]))
    assert set(ref) == set(JAX_FLAGS)
    assert set(ours) == set(JAX_FLAGS) | {"steps_per_call", "out_dir", "device"}
    assert ours[name] == ref[name]
