"""The port's sweep runner (``diffusion_extensions_tpu_torch/sweep.py``)
against the JAX package's ``tools/sweep.py`` (loaded by path, as
``tests/test_experiments.py`` does): the same metric collection and
ranking on the same logs, the same flags, and a two-point sweep of the
port's lock driver on the CPU that writes a ranked ``summary.json`` under
``tmp_path`` and leaves the committed ``sweeps/`` as it was."""
import hashlib
import importlib.util
import json
import math
import os
import re

import pytest

from diffusion_extensions_tpu_torch import sweep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_sweep():
    spec = importlib.util.spec_from_file_location("jax_sweep",
                                                  os.path.join(ROOT, "tools", "sweep.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    d = tmp_path_factory.mktemp("logs")
    paths = {}
    rows = {
        "plain": [{"loss": v} for v in (5.0, 3.0, 4.0)],
        "long": [{"loss": float(v), "step": i} for i, v in enumerate(range(30, 0, -1))],
        "nan": [{"loss": 2.0}, {"loss": float("nan")}, {"loss": 1.0}],
        "other": [{"other": 1.0}],
    }
    for name, recs in rows.items():
        path = d / f"{name}.jsonl"
        with open(path, "w") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")
            f.write("not json\n")
        paths[name] = str(path)
    paths["absent"] = str(d / "absent.jsonl")
    return paths


@pytest.mark.parametrize("agg", ["last", "min", "max", "mean10"])
@pytest.mark.parametrize("log", ["plain", "long", "nan", "other", "absent"])
def test_collect_metric_matches_jax_tool(logs, log, agg):
    want = _jax_sweep().collect_metric(logs[log], "loss", agg)
    got = sweep.collect_metric(logs[log], "loss", agg)
    assert got == want
    if log in ("other", "absent"):
        assert got is None


def test_collect_metric_unknown_agg(logs):
    for mod in (_jax_sweep(), sweep):
        with pytest.raises(ValueError, match="unknown agg"):
            mod.collect_metric(logs["plain"], "loss", "median")


@pytest.mark.parametrize("maximize", [False, True])
def test_rank_results_matches_jax_tool(maximize):
    """Equal ranks and order, a crashed run (non-zero returncode, partial
    log) and a run with no value at the bottom."""
    results = [
        {"tag": "a", "value": 2.0, "returncode": 0},
        {"tag": "b", "value": 1.0, "returncode": 0},
        {"tag": "crashed", "value": 0.5, "returncode": 1},
        {"tag": "c", "value": None, "returncode": 0},
        {"tag": "d", "value": 3.0, "returncode": 0},
    ]
    want = _jax_sweep().rank_results([dict(r) for r in results], maximize=maximize)
    got = sweep.rank_results([dict(r) for r in results], maximize=maximize)
    assert got == want
    assert [r["tag"] for r in got][-2:] == ["crashed", "c"]


def _flags(source: str) -> set:
    return set(re.findall(r'add_argument\(\s*"(--?[\w-]+|[a-z]+)"', source))


def test_flags_and_default_out():
    """The JAX tool's flags and positionals; ``--out`` defaults under
    ``torch_results/``, never the committed ``sweeps/``; the flags after
    ``--`` go to every run."""
    with open(os.path.join(ROOT, "tools", "sweep.py")) as f:
        jax_flags = _flags(f.read())
    with open(sweep.__file__) as f:
        assert _flags(f.read()) == jax_flags
    args = sweep.parse_args(["lock", "--grid", "{}"])
    assert args.out == os.path.join("torch_results", "sweeps", "run")
    args = sweep.parse_args(["lock", "--grid", "{}", "--steps", "5", "--", "--param", "so3",
                             "--device", "cpu"])
    assert args.steps == 5 and args.rest == ["--param", "so3", "--device", "cpu"]


def _tree_hash(path: str) -> str:
    h = hashlib.sha256()
    for root, dirs, files in os.walk(path):
        dirs.sort()
        for name in sorted(files):
            full = os.path.join(root, name)
            h.update(os.path.relpath(full, path).encode())
            with open(full, "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def test_two_point_lock_sweep(tmp_path):
    """Two lock runs (--param so3) over an lr grid, one subprocess each on
    the CPU: both exit 0, both are ranked by their mean loss in
    ``summary.json``, each run's log and checkpoint are under ``--out``, and
    ``sweeps/`` hashes the same before and after."""
    before = _tree_hash(os.path.join(ROOT, "sweeps"))
    out = str(tmp_path / "sweep")
    summary = sweep.main(["lock", "--grid", json.dumps({"lr": [1e-4, 3e-4]}), "--steps", "20",
                          "--out", out, "--", "--param", "so3", "--device", "cpu",
                          "--timesteps", "50", "--print-every", "5"])
    with open(os.path.join(out, "summary.json")) as f:
        on_disk = json.load(f)
    assert on_disk == summary
    ranked = on_disk["ranked"]
    assert sorted(r["tag"] for r in ranked) == ["lr0.0001", "lr0.0003"]
    assert [r["returncode"] for r in ranked] == [0, 0]
    values = [r["value"] for r in ranked]
    assert all(math.isfinite(v) for v in values) and values == sorted(values)
    assert [r["rank"] for r in ranked] == [1, 2]
    for r in ranked:
        with open(os.path.join(out, r["tag"], "metrics.jsonl")) as f:
            assert len(f.readlines()) == 4  # 20 steps, a row every 5
        assert sorted(os.listdir(os.path.join(out, r["tag"], "ckpt"))) == ["step_00000020.pt"]
    assert _tree_hash(os.path.join(ROOT, "sweeps")) == before
