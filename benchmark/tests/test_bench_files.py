"""BENCHMARK.json against the contract, and every file it names found by
name and valid."""
import json
import math
import os
import re

import pytest

from benchmark.harness import files

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = files.benchmark()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(files.ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(files.ROOT, p))
    for w in BENCH["command"][1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_the_full_check_fits_its_time():
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
])
def test_entries(section, keys):
    entries = BENCH[section]
    assert 1 <= len(entries) <= 24
    assert len({e["name"] for e in entries}) == len(entries)
    for e in entries:
        assert set(e) == keys
        assert NAME.match(e["name"]) and _line(e["why"])


def test_configs_are_files_of_their_own():
    used = {w["config"] for w in BENCH["workloads"]}
    seen = set()
    for c in BENCH["configs"]:
        assert c["name"] in used and _line(c["source"]) and c["source"].startswith("https://")
        assert c["file"] not in seen and c["file"].startswith("benchmark/")
        seen.add(c["file"])
        body = files.config(c["name"])
        assert os.path.basename(c["file"]) == c["name"] + ".json"
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_cells():
    pairs = set()
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = files.workload(w["name"])
        assert {k: cell[k] for k in ("config", "traffic", "chips", "why")} == {
            k: w[k] for k in ("config", "traffic", "chips", "why")}
        assert cell["limits"] and all(v > 0 for v in cell["limits"].values())
        traffic = files.traffic(w["traffic"])
        assert files.loop(traffic["kind"]).run
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and NAME.match(m["name"]) and UNIT.match(m["unit"])
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"]) and UNIT.match(m["unit"]) and NAME.match(m["name"])
        reader = files.metric(m["name"])
        assert (reader.LAYER, reader.UNIT, reader.MOVES) == (m["layer"], m["unit"], m["moves"])
        for cell in m.get("workloads", cells):
            assert cell in cells and cell in e2e[m["moves"]].get("workloads", cells)
    for cell in cells:
        reported = files.cell_metrics(BENCH, cell, "end_to_end")
        assert any(m["name"] == "setup_s" for m in reported) and len(reported) >= 2
        assert files.cell_metrics(BENCH, cell, "per_layer")


def test_layers_are_named_in_perf_md():
    text = open(os.path.join(files.ROOT, "PERF.md")).read()
    for m in BENCH["per_layer"]:
        assert f"| {m['layer']} |" in text


@pytest.mark.parametrize("cfg", [c["name"] for c in BENCH["configs"]])
def test_parameter_count(cfg):
    body = files.config(cfg)
    spec = files.family(body["family"]).param_spec(body)
    assert sum(math.prod(s) for _, s, _ in spec) == body["params"]


def test_files_are_named_from_names():
    for sub in ("configs", "workloads", "traffic", "metrics"):
        for f in os.listdir(os.path.join(files.HERE, sub)):
            if f.startswith("__") or f.endswith(".pyc") or f == "synthetic.py":
                continue
            assert NAME.match(f.rsplit(".", 1)[0]), f
    assert json.loads(open(os.path.join(files.ROOT, "BENCHMARK.json")).read())
