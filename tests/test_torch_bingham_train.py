"""The training side of the port's Bingham driver on the CPU at a small
size: ``train()`` end to end with the online MMD curve, the steps it
evaluates at against the JAX driver's loop, ``all`` (train then test per
preset), resume, and ``--test`` on the written checkpoint directory."""
import json
import os

import numpy as np
import pytest
import torch

from diffusion_extensions_tpu.experiments import bingham as jbingham
from diffusion_extensions_tpu_torch.data.synthetic import BINGHAM_COVS
from diffusion_extensions_tpu_torch.experiments import bingham
from diffusion_extensions_tpu_torch.train.state import latest_step

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def small(monkeypatch, tmp_path):
    """96 target and model samples, T = 20; the cwd is a temporary directory."""
    monkeypatch.setattr(bingham, "SAMPLES", 96)
    monkeypatch.setattr(bingham, "NET_SAMPLES", 96)
    monkeypatch.setattr(bingham, "MMD_CHUNK", 40)
    monkeypatch.chdir(tmp_path)
    return ["--device", "cpu", "--timesteps", "20", "--batch", "16",
            "--out-dir", str(tmp_path / "out")]


def _results_mtimes():
    d = os.path.join(ROOT, "results")
    return {f: os.path.getmtime(os.path.join(d, f)) for f in os.listdir(d)}


def test_train_end_to_end_writes_the_curve_to_out_dir(small, tmp_path, capsys):
    before = _results_mtimes()
    ckpt, log = str(tmp_path / "ck"), str(tmp_path / "log.jsonl")
    got = bingham.main(["lcr", "--steps", "40", "--mmd-every", "20", "--ckpt", ckpt,
                        "--log", log, "--print-every", "16"] + small)
    curve = got["lcr"]
    # K = 16: calls end at 16, 32 and 40 (the exact tail); 32 passed 20, 40 is the end
    assert [c["step"] for c in curve] == [32, 40]
    assert all(np.isfinite(c["mmd"]) and c["seconds"] > 0 for c in curve)
    with open(tmp_path / "out" / "torch_bingham_mmd_curve_lcr.json") as f:
        assert json.load(f) == curve
    assert sorted(os.listdir(tmp_path)) == ["ck", "log.jsonl", "out"]
    assert latest_step(ckpt) == 40
    with open(log) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [16, 32]  # the call from 32 to 40 passed no multiple
    assert all(set(r) == {"step", "loss", "steps_per_sec"} for r in rows)
    out = capsys.readouterr().out
    assert '"cov": "lcr", "step": 32, "mmd"' in out
    assert _results_mtimes() == before  # the repository's results/ is untouched

    # --test reads the checkpoint directory: no warning
    recs = bingham.main(["lcr", "--test", "--ckpt", ckpt] + small)["lcr"]
    assert "untrained" not in capsys.readouterr().out
    assert recs[0]["sampler"] == "ancestral_1000" and np.isfinite(recs[0]["mmd"])

    # resume: 24 more steps from 40, the curve of this run alone
    more = bingham.main(["lcr", "--steps", "64", "--mmd-every", "20", "--ckpt", ckpt,
                         "--resume"] + small)["lcr"]
    assert [c["step"] for c in more] == [64] and latest_step(ckpt) == 64


def _jax_eval_steps(steps, k_flag, every):
    """The steps at which the JAX driver's loop (``bingham.py:103-121``)
    evaluates the MMD, with its last call cut to ``steps``."""
    k = max(min(k_flag, steps), 1)
    hits, i = [], 0
    while i < steps:
        i += k
        if i % every < k or i >= steps:
            hits.append(min(i, steps))
    return hits


@pytest.mark.parametrize("steps,k,every", [(40, 16, 20), (48, 16, 16), (50, 7, 10), (30, 1, 10),
                                           (10, 16, 100), (64, 16, 1000)])
def test_mmd_every_hits_the_jax_drivers_steps(small, tmp_path, steps, k, every, monkeypatch):
    """Including the final step, K not dividing the interval, and K larger
    than ``--steps``."""
    calls = []
    monkeypatch.setattr(bingham, "_make_mmd_eval",
                        lambda *a: (lambda step: (calls.append(step), (0.0, 0.0))[1]))
    curve = bingham.main(["lcr", "--steps", str(steps), "--steps-per-call", str(k),
                          "--mmd-every", str(every), "--ckpt", str(tmp_path / "ck"),
                          "--ckpt-every", "1000"] + small)["lcr"]
    assert calls == [c["step"] for c in curve] == _jax_eval_steps(steps, k, every)
    assert calls[-1] == steps


def test_mmd_every_0_disables_the_curve(small, tmp_path):
    got = bingham.main(["lcr", "--steps", "8", "--mmd-every", "0", "--ckpt",
                        str(tmp_path / "ck")] + small)
    assert got == {"lcr": []} and not os.path.exists(tmp_path / "out")


def test_all_trains_then_tests_every_preset(small, tmp_path, capsys):
    got = bingham.main(["all", "--steps", "16", "--mmd-every", "16"] + small)
    assert sorted(got) == sorted(BINGHAM_COVS)
    for cov, recs in got.items():
        assert recs[0]["cov"] == cov and recs[0]["sampler"] == "ancestral_1000"
        assert latest_step(str(tmp_path / "weights" / f"bingham_{cov}")) == 16
    files = sorted(os.listdir(tmp_path / "out"))
    assert files == sorted([f"torch_bingham_mmd_curve_{c}.json" for c in BINGHAM_COVS]
                           + [f"torch_bingham_mmd_{c}.json" for c in BINGHAM_COVS])
    assert "untrained" not in capsys.readouterr().out


def test_training_lowers_the_loss(small, tmp_path):
    log = str(tmp_path / "log.jsonl")
    bingham.main(["sur", "--steps", "320", "--mmd-every", "0", "--print-every", "16", "--log", log,
                  "--lr", "3e-3", "--ckpt", str(tmp_path / "ck")] + small)
    with open(log) as f:
        losses = [json.loads(line)["loss"] for line in f]
    assert len(losses) == 20 and np.mean(losses[-5:]) < np.mean(losses[:5])


TRAIN_FLAGS = ["cov", "batch", "lr", "steps", "steps_per_call", "mmd_every", "timesteps", "seed",
               "ckpt", "ckpt_every", "print_every", "log", "resume", "debug_nans", "test",
               "sampler_ab"]


@pytest.mark.parametrize("name", TRAIN_FLAGS)
def test_parser_option_matches_the_jax_drivers(name):
    ref, ours = vars(jbingham.parse_args(["lcr"])), vars(bingham.parse_args(["lcr"]))
    assert set(ref) == set(TRAIN_FLAGS) and set(ours) == set(TRAIN_FLAGS) | {"device", "out_dir"}
    assert ours[name] == ref[name]
