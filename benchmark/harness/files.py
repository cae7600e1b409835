"""The benchmark's files, found by name: ``BENCHMARK.json`` at the root
of the checkout, ``configs/<name>.json``, ``workloads/<name>.json``,
``traffic/<name>.json``, ``metrics/<name>.py``, ``families/<name>.py``
and ``loops/<kind>.py`` under ``benchmark/``."""
from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


def config(name: str) -> dict:
    return _json(os.path.join(HERE, "configs", name + ".json"))


def workload(name: str) -> dict:
    return _json(os.path.join(HERE, "workloads", name + ".json"))


def traffic(name: str) -> dict:
    return _json(os.path.join(HERE, "traffic", name + ".json"))


def family(name: str):
    return importlib.import_module(f"benchmark.families.{name}")


def loop(kind: str):
    return importlib.import_module(f"benchmark.loops.{kind}")


def metric(name: str):
    """The reader of a per-layer metric: a module with ``LAYER``, ``UNIT``,
    ``MOVES`` and ``read(ctx) -> float | None``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, section: str) -> list:
    """The entries of ``section`` ("end_to_end" or "per_layer") that the
    cell reports: those that list it, and those that list no cells."""
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]
