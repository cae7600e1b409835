"""The trace's arithmetic and the per-layer readers."""
import os

import pytest

from benchmark.flops import PEAK_BF16_FLOPS
from benchmark.harness import files
from benchmark.harness import trace


def test_union_counts_overlap_once():
    assert trace.union([(5, 9), (0, 2), (1, 3), (8, 10)]) == [[0, 3], [5, 10]]
    assert trace.busy([(0, 10), (2, 4), (3, 12), (20, 21)]) == 13


def test_gaps_are_named_by_the_innermost_host_op():
    host = [("outer", 0, 100), ("cudaGraphLaunch", 40, 60), ("later", 70, 80)]
    assert trace._name_gaps([(45, 55), (85, 95), (101, 110)], host) == [
        ["cudaGraphLaunch", 10 / 1e9], ["outer", 10 / 1e9], ["no host op", 9 / 1e9]]


TRAIN = {"busy_s": 0.9, "window_s": 1.0, "kernels": 800, "steps": 80, "flops_step": 686e9,
         "wall_per_step_s": 0.0125, "device_ops": [], "idle_gaps": []}
SAMPLE = {"busy_s": 0.4, "window_s": 4.0, "kernels": 100_000, "calls": 2, "sampler_steps": 100, "forwards": 102,
          "flops_forward": 825e9, "wall_per_call_s": 1.0, "device_ops": [], "idle_gaps": []}


def _readers() -> dict:
    """Every reader under metrics/, listed in BENCHMARK.json or not."""
    names = [f[:-3] for f in os.listdir(os.path.join(files.HERE, "metrics")) if not f.startswith("__")]
    return {n: files.metric(n).read for n in names}


def test_readers():
    read = _readers()
    assert read["train.mfu"](TRAIN) == pytest.approx(100 * 686e9 / 0.0125 / PEAK_BF16_FLOPS)
    assert read["device.idle_pct.train"](TRAIN) == pytest.approx(10.0)
    assert read["sample.mfu"](SAMPLE) == pytest.approx(100 * 51 * 825e9 / 1.0 / PEAK_BF16_FLOPS)
    assert read["device.idle_pct.sample"](SAMPLE) == pytest.approx(80.0)
    assert read["sampler.launches_per_step"](SAMPLE) == 1000.0


def test_readers_find_nothing_outside_their_cells():
    read = _readers()
    for name in ("train.mfu", "device.idle_pct.train"):
        assert read[name](SAMPLE) is None
    for name in ("sample.mfu", "device.idle_pct.sample", "sampler.launches_per_step"):
        assert read[name](TRAIN) is None
