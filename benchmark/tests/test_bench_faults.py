"""A whole run on the CPU at a small size, the look for a card skipped:
sound, it comes out correct; with a fault planted underneath the timed
path, not."""
import time

import pytest

from benchmark import faults
from benchmark.harness import cell
from benchmark.tests import small

SEED = 2 ** 31 + 77


def _run(name):
    overrides, traffic = small.CELLS[name]
    # float32 program: at these sizes bf16's gaps are not the cells' own
    out = cell.run(name, SEED, 0.5, False, "cpu", time.perf_counter(), dict(overrides, bf16=False), traffic)
    return out["result"]


@pytest.mark.parametrize("name", list(small.CELLS))
def test_sound_run_is_correct(name):
    result = _run(name)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks" and result["attempted"] >= 1 and result["failed"] == 0
    assert "setup_s" in result["metrics"]


@pytest.mark.parametrize("name,fault", [(n, f) for n in ("aircraft-train", "protein-train") for f in faults.TRAIN]
                         + [("protein-sample", f) for f in faults.SAMPLE])
def test_fault_is_not_correct(name, fault):
    kind = "sample" if name == "protein-sample" else "train"
    with faults.planted(kind, fault):
        result = _run(name)
    assert not result["correct"], result["checks"]
