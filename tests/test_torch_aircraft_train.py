"""The training side of the port's aircraft driver on the CPU at small sizes:
the host batcher against the JAX package's, the frozen validation probe
against the JAX driver's formula, ``main`` end to end (JSONL rows,
checkpoints, ``--resume``, ``--test`` on the directory), the flags the port
does not serve yet, the native loader, and the parser against the JAX
driver's."""
import json
import os
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffusion_extensions_tpu.data.shapenet import BatchLoader as JBatchLoader
from diffusion_extensions_tpu.experiments import aircraft as jaircraft
from diffusion_extensions_tpu.models.planenet import PlaneNet as JPlaneNet
from diffusion_extensions_tpu.models.projections import PointCloudProj as JProj
from diffusion_extensions_tpu.ops.so3 import log_rmat_vec as j_log_rmat_vec
from diffusion_extensions_tpu.processes.schedule import extract as j_extract
from diffusion_extensions_tpu.processes.so3 import ProjectedSO3Diffusion as JProjected
from diffusion_extensions_tpu_torch import obs
from diffusion_extensions_tpu_torch.convert import planenet_params_from_flax
from diffusion_extensions_tpu_torch.data.shapenet import BatchLoader, synthetic_planes
from diffusion_extensions_tpu_torch.experiments import aircraft
from diffusion_extensions_tpu_torch.models.planenet import PlaneNet
from diffusion_extensions_tpu_torch.ops._build import BUILD_DIR
from diffusion_extensions_tpu_torch.processes.so3 import ProjectedSO3Diffusion
from diffusion_extensions_tpu_torch.train.state import latest_step

torch.set_num_threads(1)
SMALL = ["--so3", "--device", "cpu", "--dim", "32", "--heads", "2", "--layers", "1",
         "--batch", "8", "--samples", "16", "--timesteps", "50", "--data-root", "/nonexistent"]


@pytest.mark.parametrize("samples,drop_last", [(16, True), (None, True), (16, False)])
def test_batch_loader_is_bit_equal_to_the_jax_loader(samples, drop_last):
    """Three epochs' worth of batches, the same seed: the same bits (both
    are numpy).  Without ``drop_last`` the ragged last batch comes too."""
    data = synthetic_planes(21, 64, seed=3)
    kw = dict(samples=samples, seed=5, drop_last=drop_last)
    ref = iter(JBatchLoader(data, 4, device_put=False, **kw))
    ours = iter(BatchLoader(data, 4, **kw))
    per_epoch = 5 if drop_last else 6
    shapes = set()
    for _ in range(3 * per_epoch):
        a, b = next(ours), next(ref)
        assert isinstance(a, torch.Tensor) and a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b)
        shapes.add(tuple(a.shape))
    assert shapes == {(4, samples or 64, 3)} | (set() if drop_last else {(1, samples or 64, 3)})
    unshuffled = next(iter(BatchLoader(data, 4, shuffle=False)))
    np.testing.assert_array_equal(unshuffled.numpy(), data[:4])


def test_frozen_probe_matches_the_jax_drivers_val_loss():
    """``make_val_probe`` with JAX's t_v and noise_v against the formula of
    the JAX driver (``aircraft.py:190-204``): rtol 1e-5.  The probe leaves
    the model in training mode and its weights trainable."""
    b, n, t_steps = 8, 16, 100
    rng = np.random.default_rng(1)
    clouds = rng.standard_normal((b, n, 3)).astype(np.float32)
    jmodel = JPlaneNet(dim=32, heads=2, layers=1)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(clouds), jnp.zeros((b,), jnp.int32))
    jproc = JProjected(t_steps)
    truepos = jnp.broadcast_to(jnp.eye(3), (b, 3, 3))
    t_v = jax.random.randint(jax.random.PRNGKey(7), (b,), 0, t_steps)
    noise_v = jproc.q_table.sample(jax.random.PRNGKey(8), t_v)
    eps_v = j_extract(jproc.schedule.sqrt_one_minus_alphas_cumprod, t_v)
    target_v = j_log_rmat_vec(noise_v) / eps_v[..., None]
    x_in = JProj(jnp.asarray(clouds), so3=True)(jproc.q_sample(truepos, t_v, noise_v))
    ref = float(jnp.mean((jmodel.apply(params, x_in, t_v) - target_v) ** 2))

    model = PlaneNet(dim=32, heads=2, layers=1)
    model.load_state_dict(planenet_params_from_flax(
        jax.tree_util.tree_map(np.asarray, jax.device_get(params))))
    proc = ProjectedSO3Diffusion(t_steps, device="cpu")
    val_loss = aircraft.make_val_probe(model, proc, torch.from_numpy(clouds),
                                       torch.from_numpy(np.array(t_v)).long(),
                                       torch.from_numpy(np.array(noise_v)))
    out = val_loss()
    np.testing.assert_allclose(float(out), ref, rtol=1e-5)
    assert not out.requires_grad and model.training
    assert all(p.requires_grad and not p.is_inference() for p in model.parameters())
    assert float(val_loss()) == float(out)  # frozen: the same value again


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_train_end_to_end_then_resume_then_test(tmp_path, capsys):
    """``main([... "--steps", "30"])``: JSONL rows, checkpoints; ``--resume``
    continues from the stored step with K = 4 and an exact tail; ``--test``
    reads the directory."""
    ckpt, log = str(tmp_path / "ck"), str(tmp_path / "log.jsonl")
    args = SMALL + ["--ckpt", ckpt, "--log", log, "--ckpt-every", "10"]
    state = aircraft.main(args + ["--steps", "30"])
    out = capsys.readouterr().out
    assert state.step == 30 and "PlaneNet params: 0.14M" in out and "step 30: loss=" in out
    rows = _rows(log)
    assert [r["step"] for r in rows] == [10, 20, 30]
    assert all(set(r) == {"step", "loss", "test_loss", "steps_per_sec"} for r in rows)
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["test_loss"]) for r in rows)
    assert np.isnan(rows[0]["steps_per_sec"]) and rows[-1]["steps_per_sec"] > 0
    assert sorted(os.listdir(ckpt)) == [f"step_{s:08d}.pt" for s in (10, 20, 30)]

    # resume: 15 more steps in calls of 4, the last call of 3; norms logged
    state = aircraft.main(args + ["--steps", "45", "--resume", "--steps-per-call", "4",
                                  "--print-every", "1", "--log-norms-per-layer",
                                  "--opt-impl", "optax"])
    rows = _rows(log)[3:]
    assert state.step == 45 and [r["step"] for r in rows] == [34, 38, 42, 45]
    assert {"grad_norm", "param_norm", "grad_norm/siren", "grad_norm/encoder",
            "grad_norm/pool", "grad_norm/head"} <= set(rows[-1])
    assert latest_step(ckpt) == 45 and len(os.listdir(ckpt)) == 3
    # the model a run hands back is still trainable
    assert state.model.training and all(p.requires_grad for p in state.model.parameters())

    capsys.readouterr()
    res = aircraft.main(SMALL + ["--test", "--ckpt", ckpt, "--max-shapes", "8",
                                 "--timesteps", "50"])
    out = capsys.readouterr().out
    assert "no checkpoint found" not in out and res.shape == (8 * aircraft.SAMPLES_PER_SHAPE,)
    # a model of another width does not fit the stored weights
    with pytest.raises(ValueError, match="shape mismatch at siren.lin.weight"):
        aircraft.main([a if a != "32" else "64" for a in SMALL] + ["--test", "--ckpt", ckpt])


def test_without_resume_training_starts_from_step_0(tmp_path):
    ckpt = str(tmp_path / "ck")
    args = SMALL + ["--ckpt", ckpt, "--steps", "3", "--no-native"]
    a = aircraft.main(args)
    b = aircraft.main(args)  # no --resume: the same run again, the same weights
    assert a.step == b.step == 3
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)


def test_profile_dir_and_debug_nans(tmp_path, capsys):
    """``--profile-dir`` writes a Chrome trace of steps 50-60 and the spans
    of the run up to its end; ``--debug-nans`` runs the steps under
    ``torch.autograd.set_detect_anomaly``."""
    prof = tmp_path / "prof"
    state = aircraft.main(SMALL + ["--ckpt", str(tmp_path / "ck"), "--steps", "62", "--no-native",
                                   "--profile-dir", str(prof), "--debug-nans",
                                   "--steps-per-call", "2"])
    assert state.step == 62 and not torch.is_anomaly_enabled()
    assert f"profiler trace written to {prof}" in capsys.readouterr().out
    with open(prof / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    with open(prof / "spans.json") as f:
        spans = json.load(f)
    assert [r[0] for r in spans["host"]].count("train.step") == 60  # eager steps 0-59
    assert spans["counters"]["train.eager_steps"] == 60 and not obs.enabled()


def test_loss_falls_over_200_small_steps(tmp_path):
    log = str(tmp_path / "log.jsonl")
    aircraft.main(SMALL + ["--ckpt", str(tmp_path / "ck"), "--log", log, "--steps", "200",
                           "--print-every", "1", "--lr", "1e-3", "--no-native"])
    losses = [r["loss"] for r in _rows(log)]
    probe = [r["test_loss"] for r in _rows(log)]
    assert len(losses) == 200 and np.isfinite(losses).all()
    assert np.mean(losses[-20:]) < np.mean(losses[:20])
    assert probe[-1] < probe[0]


@pytest.mark.parametrize("flag,item", [(["--tp", "2"], "A.8"), (["--sp", "2"], "A.8"),
                                       (["--fsdp"], "A.8"), (["--moe-experts", "4"], "A.8")])
def test_flags_not_ported_yet_exit_with_the_roadmap_item(flag, item, tmp_path):
    """The four flags that waited for ROADMAP.md's item (A.8, closed) are
    served now: in one process ``--fsdp`` and ``--moe-experts`` train and
    evaluate, ``--tp 2`` and ``--sp 2`` ask for the processes their mesh
    needs (``tests/test_torch_parallel.py`` runs them on 2 and 4)."""
    assert not hasattr(aircraft, "NOT_PORTED")
    args = SMALL + flag + ["--ckpt", str(tmp_path / "ck"), "--no-native"]
    if flag[0] in ("--tp", "--sp"):
        with pytest.raises(SystemExit, match="need a multiple of 2 processes.*torchrun"):
            aircraft.main(args + ["--steps", "1"])
    else:
        assert aircraft.main(args + ["--steps", "2"]).step == 2
    res = aircraft.main(args + ["--test", "--max-shapes", "8", "--timesteps", "10"])
    assert res.shape == (8 * aircraft.SAMPLES_PER_SHAPE,) and np.isfinite(res).all()
    assert not torch.distributed.is_initialized()


def test_train_defaults_to_the_card():
    """Without ``--device`` training runs on cuda: with no card it raises,
    it does not move to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    with pytest.raises((RuntimeError, AssertionError)):
        aircraft.main([a for a in SMALL if a not in ("--device", "cpu")] + ["--steps", "1"])


def test_native_loader_builds_into_the_ports_build_directory(capsys, tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    from diffusion_extensions_tpu_torch.data import native

    path = native.build_native()
    assert os.path.dirname(path) == str(BUILD_DIR) and os.path.isfile(path)
    assert native.native_available()
    data = synthetic_planes(16, 64, seed=1)
    loader = native.NativeBatchLoader(data, 4, samples=16, seed=0)
    try:
        for _ in range(6):
            batch = next(loader)
            assert isinstance(batch, torch.Tensor) and batch.shape == (4, 16, 3)
            assert batch.dtype == torch.float32 and torch.isfinite(batch).all()
            # every point of a batch row is a point of one source cloud
            row = batch[0].numpy()
            assert any(all((cloud == p).all(axis=1).any() for p in row) for cloud in data)
    finally:
        loader.close()
    with pytest.raises(StopIteration):
        next(loader)
    # ``main`` announces which loader it took
    aircraft.main(SMALL + ["--ckpt", str(tmp_path / "a"), "--steps", "1"])
    assert "using native threaded batch loader" in capsys.readouterr().out
    aircraft.main(SMALL + ["--ckpt", str(tmp_path / "b"), "--steps", "1", "--no-native"])
    assert "native" not in capsys.readouterr().out


def test_native_loader_unavailable_falls_back_to_numpy(monkeypatch, capsys, tmp_path):
    """The reference's own behaviour for its host loader: the printed line,
    then the numpy loader."""
    from diffusion_extensions_tpu_torch.data import native

    def broken(*a, **k):
        raise OSError("no compiler")

    monkeypatch.setattr(native, "NativeBatchLoader", broken)
    state = aircraft.main(SMALL + ["--ckpt", str(tmp_path / "ck"), "--steps", "2"])
    assert state.step == 2
    assert "native loader unavailable (no compiler); using numpy loader" in capsys.readouterr().out


# every option of the JAX driver's parser (aircraft.py:367-431)
JAX_FLAGS = ["batch", "lr", "clip", "lr_schedule", "opt_impl", "opt_state_dtype", "samples",
             "dim", "heads", "layers", "so3", "bf16", "no_native", "steps_per_call", "tp",
             "fsdp", "sp", "moe_experts", "moe_dispatch", "log_norms", "log_norms_per_layer",
             "timesteps", "steps", "seed", "data_root", "ckpt", "ckpt_every", "print_every",
             "log", "profile_dir", "resume", "debug_nans", "test", "euler_init", "max_shapes"]
ALL_SET = ["--batch", "3", "--lr", "0.5", "--clip", "2.0", "--lr-schedule", "cosine",
           "--opt-impl", "fused", "--opt-state-dtype", "bf16", "--samples", "7", "--dim", "8",
           "--heads", "2", "--layers", "3", "--so3", "--bf16", "--no-native",
           "--steps-per-call", "4", "--tp", "2", "--fsdp", "--sp", "2", "--moe-experts", "4",
           "--moe-dispatch", "onehot", "--log-norms", "--log-norms-per-layer",
           "--timesteps", "9", "--steps", "11", "--seed", "5", "--data-root", "d",
           "--ckpt", "c", "--ckpt-every", "6", "--print-every", "2", "--log", "l",
           "--profile-dir", "p", "--resume", "--debug-nans", "--test",
           "--euler-init", "marginal", "--max-shapes", "12"]


@pytest.mark.parametrize("name", JAX_FLAGS)
def test_parser_option_matches_the_jax_drivers(name):
    """Each option: the same default, and the same value from the same
    command line."""
    ref, ours = vars(jaircraft.parse_args([])), vars(aircraft.parse_args([]))
    # the port's own: --device, and --trunk (the JAX driver has only the encoder)
    assert set(ref) == set(JAX_FLAGS) and set(ours) == set(JAX_FLAGS) | {"device", "trunk"}
    assert ours[name] == ref[name]
    ref, ours = vars(jaircraft.parse_args(ALL_SET)), vars(aircraft.parse_args(ALL_SET))
    assert ours[name] == ref[name] and ours["device"] is None and ours["trunk"] == "transformer"
    assert aircraft.parse_args(["--so3"]).ckpt == jaircraft.parse_args(["--so3"]).ckpt
