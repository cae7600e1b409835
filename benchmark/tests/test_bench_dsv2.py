"""The ``planenet_dsv2`` family (``dsv2lite-aircraft-train``) on the CPU at
small sizes: its weight layout is the program's, its frozen FLOP form is
FlopCounterMode's count plus the grouped products, its two readers read
the program's counters, a whole run comes out correct, and faults planted
underneath (half the batch, a state unchanged, each routing fault) do not."""
import time

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import faults
from benchmark.flops import dsv2 as flops
from benchmark.harness import cell, files
from benchmark.harness import weights as wts
from benchmark.tests.test_bench_trace import SAMPLE, TRAIN

CELL = "dsv2lite-aircraft-train"
SMALL = dict(hidden_size=64, num_attention_heads=4, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
             v_head_dim=16, intermediate_size=96, moe_intermediate_size=32, n_routed_experts=8,
             num_experts_per_tok=2, experts_held=4, num_hidden_layers=3, batch=4, points=16, timesteps=50)
SEED = 2 ** 31 + 77
CPU = torch.device("cpu")


def _cfg(**extra) -> dict:
    return dict(files.config(files.workload(CELL)["config"]), **SMALL, **extra)


@pytest.fixture
def obs():
    from diffusion_extensions_tpu_torch import obs

    obs.reset()
    yield obs
    obs.reset()


def test_spec_is_the_programs_layout():
    cfg = _cfg(bf16=False)
    fam = files.family(cfg["family"])
    w = wts.make(fam.param_spec(cfg), 1, CPU)
    model = fam.build_model(cfg, w, CPU)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {k: tuple(v.shape) for k, v in w.items()}


def test_spec_counts_the_full_configuration():
    """The cell's own configuration on the meta device, nothing made: the
    program's layout, and the file's ``params``."""
    cfg = files.config(files.workload(CELL)["config"])
    fam = files.family(cfg["family"])
    spec = {n: s for n, s, _ in fam.param_spec(cfg)}
    from diffusion_extensions_tpu_torch.models.planenet import PlaneNet

    with torch.device("meta"):
        model = PlaneNet(trunk=fam.trunk_config(cfg))
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == spec
    assert sum(int(np.prod(s)) for s in spec.values()) == cfg["params"]


def test_trunk_is_the_drivers_preset():
    from diffusion_extensions_tpu_torch.models.deepseek_v2 import TRUNKS

    cfg = files.config(files.workload(CELL)["config"])
    assert files.family(cfg["family"]).trunk_config(cfg) == TRUNKS["dsv2lite-ep8"]


@pytest.mark.parametrize("bf16", [False, True])
def test_frozen_flops_are_flopcountermodes_plus_the_grouped_rows(obs, bf16):
    """FlopCounterMode counts no ``torch._grouped_mm``: the frozen form's
    ``counted`` is its count of a forward exactly, and ``routed`` at the
    rows that forward sent to the held experts (the program's counter)
    the rest; ``forward`` takes the expected rows."""
    cfg = _cfg(bf16=bf16)
    fam = files.family(cfg["family"])
    model = fam.build_model(cfg, wts.make(fam.param_spec(cfg), 1, CPU), CPU)
    pool, _ = fam.train_inputs(cfg, 1, np.random.default_rng(0), CPU)
    t = torch.zeros(cfg["batch"], dtype=torch.long)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(pool[0], t)
    assert counter.get_total_flops() == flops.counted(cfg, cfg["batch"], cfg["points"])
    rows = obs.snapshot()["counters"]["moe.rows"]
    moe_layers = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    assert flops.routed(cfg, rows / moe_layers) == 2 * 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"] * rows
    assert fam.forward_flops(cfg) == flops.counted(cfg, cfg["batch"], cfg["points"]) + flops.routed(
        cfg, cfg["batch"] * cfg["points"] * 2 * 4 / 8)


def test_frozen_flops_are_the_programs_closed_form():
    from diffusion_extensions_tpu_torch.flops import dsv2_planenet_flops

    cfg = files.config(files.workload(CELL)["config"])
    fam = files.family(cfg["family"])
    assert fam.forward_flops(cfg) == dsv2_planenet_flops(fam.trunk_config(cfg), cfg["batch"], cfg["points"])


COUNTERS = {"train.captures": 1, "moe.rows": 4 * 8 * 12_000, "moe.rows_max": 4 * 8 * 1_800,
            "moe.layer_steps": 4 * 8, "moe.experts_held": 4 * 8 * 8, "moe.graph_kernels": 4 * 60, "moe.captures": 4}


def _read(name, ctx):
    return files.metric(name).read(ctx)


def test_readers_take_the_snapshot_in_the_context():
    ctx = dict(TRAIN, spans={"counters": COUNTERS})
    assert _read("moe.load_max_over_mean", ctx) == pytest.approx(1800 / (12000 / 8))
    assert _read("moe.kernels_per_layer", ctx) == 60


def test_readers_take_the_programs_live_counters(obs):
    cfg = _cfg(bf16=False)
    fam = files.family(cfg["family"])
    model = fam.build_model(cfg, wts.make(fam.param_spec(cfg), 1, CPU), CPU)
    pool, _ = fam.train_inputs(cfg, 1, np.random.default_rng(0), CPU)
    with torch.no_grad():
        model(pool[0], torch.zeros(cfg["batch"], dtype=torch.long))
    c = obs.snapshot()["counters"]
    mean = c["moe.rows"] / (c["moe.layer_steps"] * cfg["experts_held"])
    assert _read("moe.load_max_over_mean", TRAIN) == pytest.approx(c["moe.rows_max"] / c["moe.layer_steps"] / mean)
    assert _read("moe.load_max_over_mean", TRAIN) >= 1.0
    assert _read("moe.kernels_per_layer", TRAIN) is None  # nothing captured on the CPU
    obs.count("moe.graph_kernels", 120)
    obs.count("moe.captures", 2)
    assert _read("moe.kernels_per_layer", TRAIN) == 60


@pytest.mark.parametrize("name", ["moe.load_max_over_mean", "moe.kernels_per_layer"])
def test_readers_find_nothing_without_moe_counters_or_outside_training(obs, name, monkeypatch):
    assert _read(name, TRAIN) is None
    assert _read(name, dict(TRAIN, spans={"counters": {"train.captures": 1, "train.graph_kernels": 714}})) is None
    assert _read(name, dict(SAMPLE, spans={"counters": COUNTERS})) is None
    import sys

    import diffusion_extensions_tpu_torch as program

    monkeypatch.delattr(program, "obs")
    monkeypatch.setitem(sys.modules, "diffusion_extensions_tpu_torch.obs", None)  # a program without obs
    assert _read(name, TRAIN) is None


def _run():
    # float32 program: at these sizes bf16's gaps are not the cell's own
    return cell.run(CELL, SEED, 0.5, False, "cpu", time.perf_counter(), dict(SMALL, bf16=False))["result"]


def test_sound_run_is_correct():
    result = _run()
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "train_step_ms", "peak_mem_gib"}


@pytest.mark.parametrize("fault", faults.TRAIN)
def test_fault_is_not_correct(fault):
    with faults.planted("train", fault):
        result = _run()
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", ["top_k_minus_one", "renormalised"])
def test_routing_fault_is_not_correct(fault):
    with files.family("planenet_dsv2").routing_fault(fault):
        result = _run()
    assert not result["correct"], result["checks"]
