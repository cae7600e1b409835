"""The readers of the program's counters, fed made-up trace contexts and
the program's live counters."""
import pytest

from benchmark.harness import files
from benchmark.tests.test_bench_trace import SAMPLE, TRAIN

NEW = ("train.kernels_per_step", "setup.capture_s")
COUNTERS = {"train.captures": 1, "train.graph_kernels": 1976, "train.capture_ns": 1_250_000_000,
            "train.replays": 800, "train.eager_steps": 3}


@pytest.fixture
def obs():
    from diffusion_extensions_tpu_torch import obs

    obs.reset()
    yield obs
    obs.reset()


def _read(name, ctx):
    return files.metric(name).read(ctx)


def test_readers_take_the_snapshot_in_the_context():
    ctx = dict(TRAIN, spans={"counters": COUNTERS})
    assert _read("train.kernels_per_step", ctx) == 1976
    assert _read("setup.capture_s", ctx) == pytest.approx(1.25)
    two = dict(COUNTERS, **{"train.captures": 2, "train.graph_kernels": 3000})
    assert _read("train.kernels_per_step", dict(TRAIN, spans={"counters": two})) == 1500


def test_readers_take_the_programs_live_counters(obs):
    for name, n in COUNTERS.items():
        obs.count(name, n)
    assert _read("train.kernels_per_step", TRAIN) == 1976
    assert _read("setup.capture_s", TRAIN) == pytest.approx(1.25)


@pytest.mark.parametrize("name", NEW)
def test_readers_find_nothing_without_a_capture_or_outside_training(obs, name):
    assert _read(name, TRAIN) is None  # nothing captured
    assert _read(name, dict(TRAIN, spans={"counters": {"train.eager_steps": 8}})) is None
    assert _read(name, dict(SAMPLE, spans={"counters": COUNTERS})) is None


@pytest.mark.parametrize("name", NEW)
def test_readers_find_nothing_in_a_program_without_counters(monkeypatch, obs, name):
    import sys

    import diffusion_extensions_tpu_torch as program

    for counter, n in COUNTERS.items():
        obs.count(counter, n)
    assert _read(name, TRAIN) is not None
    monkeypatch.delattr(program, "obs")
    monkeypatch.setitem(sys.modules, "diffusion_extensions_tpu_torch.obs", None)  # the import fails
    assert _read(name, TRAIN) is None
