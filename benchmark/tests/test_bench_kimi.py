"""The ``planenet_kimi`` family (``kimilinear-aircraft-train``) on the CPU at
small sizes: its weight layout is the program's (with the correction
biases at 0), its frozen FLOP form is FlopCounterMode's count plus the
grouped products and the program's closed form, its two new readers read
the program's counters, a whole run comes out correct, and faults planted
underneath (half the batch, a state unchanged, the top k - 1, the weights
not renormalised, the state not carried across chunks, the decay dropped)
do not."""
import time

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import faults
from benchmark.flops import kimi_linear as flops
from benchmark.harness import cell, files
from benchmark.harness import weights as wts
from benchmark.tests.test_bench_trace import SAMPLE, TRAIN

CELL = "kimilinear-aircraft-train"
SEED = 2 ** 31 + 77
CPU = torch.device("cpu")


def _small() -> dict:
    lin = files.config(files.workload(CELL)["config"])["linear_attn_config"]
    return dict(hidden_size=64, intermediate_size=96, moe_intermediate_size=32, num_experts=16,
                num_experts_per_token=4, num_attention_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
                qk_rope_head_dim=8, v_head_dim=16, linear_attn_config=dict(lin, num_heads=2, head_dim=16),
                experts_held=8, chunk_size=8, batch=4, points=40, timesteps=50)


def _cfg(**extra) -> dict:
    return dict(files.config(files.workload(CELL)["config"]), **_small(), **extra)


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
    state = model.state_dict()
    assert {k: tuple(v.shape) for k, v in model.named_parameters()} == {k: tuple(v.shape) for k, v in w.items()}
    biases = {k: v for k, v in state.items() if k.endswith("e_score_correction_bias")}
    assert len(biases) == 4 and all(torch.equal(v, torch.zeros(16)) for v in biases.values())


def test_spec_counts_the_full_configuration():
    """The cell's own configuration on the meta device, nothing made: the
    program's layout, and the file's ``params``; every catalog key as
    published but the two ``reduced`` names."""
    import json

    cfg = files.config(files.workload(CELL)["config"])
    fam = files.family(cfg["family"])
    spec = {n: s for n, s, _ in fam.param_spec(cfg)}
    from diffusion_extensions_tpu_torch.models.planenet import PlaneNet

    with torch.device("meta"):
        model = PlaneNet(trunk=fam.trunk_config(cfg))
    assert {k: tuple(v.shape) for k, v in model.named_parameters()} == spec
    assert sum(int(np.prod(s)) for s in spec.values()) == cfg["params"]
    assert cfg["reduced"] == ["num_hidden_layers", "experts_held"]
    assert cfg["published"] == {"num_hidden_layers": 27, "experts_held": 256}
    assert (cfg["num_hidden_layers"], cfg["experts_held"], cfg["batch"], cfg["points"]) == (5, 8, 16, 1024)
    bench = json.load(open(files.os.path.join(files.ROOT, "BENCHMARK.json")))
    entry = next(c for c in bench["configs"] if c["name"] == cfg["name"])
    assert entry["source"] == cfg["source"] and entry["reduced"] == cfg["reduced"]


def test_trunk_is_the_drivers_preset():
    from diffusion_extensions_tpu_torch.models.kimi_linear import TRUNKS

    cfg = files.config(files.workload(CELL)["config"])
    assert files.family(cfg["family"]).trunk_config(cfg) == TRUNKS["kimilinear-ep32"]


@pytest.mark.parametrize("bf16", [False, True])
def test_frozen_flops_are_flopcountermodes_plus_the_grouped_rows(obs, bf16):
    cfg = _cfg(bf16=bf16)
    fam = files.family(cfg["family"])
    model = fam.build_model(cfg, wts.make(fam.param_spec(cfg), 1, CPU), CPU)
    pool, _ = fam.train_inputs(cfg, 1, np.random.default_rng(0), CPU)
    t = torch.zeros(cfg["batch"], dtype=torch.long)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(pool[0], t)
    assert counter.get_total_flops() == flops.counted(cfg, cfg["batch"], cfg["points"])
    rows = obs.snapshot()["counters"]["moe.rows"]
    assert flops.routed(cfg, rows / 4) == 2 * 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"] * rows
    assert fam.forward_flops(cfg) == flops.counted(cfg, cfg["batch"], cfg["points"]) + flops.routed(
        cfg, cfg["batch"] * cfg["points"] * 4 * 8 / 16)


def test_frozen_flops_are_the_programs_closed_form():
    from diffusion_extensions_tpu_torch.flops import kimi_planenet_flops

    cfg = files.config(files.workload(CELL)["config"])
    fam = files.family(cfg["family"])
    assert fam.forward_flops(cfg) == kimi_planenet_flops(fam.trunk_config(cfg), cfg["batch"], cfg["points"])


COUNTERS = {"train.captures": 1, "moe.rows": 4 * 8 * 3_900, "moe.rows_even": 4 * 8 * 4_096,
            "kda.graph_kernels": 4 * 250, "kda.captures": 4}


def _read(name, ctx):
    return files.metric(name).read(ctx)


def test_readers_take_the_snapshot_in_the_context():
    ctx = dict(TRAIN, spans={"counters": COUNTERS})
    assert _read("kda.kernels_per_layer", ctx) == 250
    assert _read("moe.held_load_gap", ctx) == pytest.approx(1 - 3900 / 4096)
    over = dict(COUNTERS, **{"moe.rows": 4 * 8 * 4_300})  # above the even share reads as far as below it
    assert _read("moe.held_load_gap", dict(TRAIN, spans={"counters": over})) == pytest.approx(4300 / 4096 - 1)


def test_readers_take_the_programs_live_counters(obs):
    cfg = _cfg(bf16=False)
    fam = files.family(cfg["family"])
    model = fam.build_model(cfg, wts.make(fam.param_spec(cfg), 1, CPU), CPU)
    pool, _ = fam.train_inputs(cfg, 1, np.random.default_rng(0), CPU)
    with torch.no_grad():
        model(pool[0], torch.zeros(cfg["batch"], dtype=torch.long))
    c = obs.snapshot()["counters"]
    assert c["moe.rows_even"] == 4 * cfg["batch"] * cfg["points"] * 4 * 8 // 16
    assert _read("moe.held_load_gap", TRAIN) == pytest.approx(abs(c["moe.rows"] / c["moe.rows_even"] - 1))
    assert _read("kda.kernels_per_layer", TRAIN) is None  # nothing captured on the CPU
    obs.count("kda.graph_kernels", 500)
    obs.count("kda.captures", 2)
    assert _read("kda.kernels_per_layer", TRAIN) == 250


@pytest.mark.parametrize("name", ["kda.kernels_per_layer", "moe.held_load_gap"])
def test_readers_find_nothing_without_their_counters_or_outside_training(obs, name, monkeypatch):
    assert _read(name, TRAIN) is None
    parent = {"train.captures": 1, "train.graph_kernels": 1404, "moe.rows": 49_000, "moe.graph_kernels": 336,
              "moe.captures": 4}  # a program from before these counters
    assert _read(name, dict(TRAIN, spans={"counters": parent})) is None
    assert _read(name, dict(SAMPLE, spans={"counters": COUNTERS})) is None
    import sys

    import diffusion_extensions_tpu_torch as program

    monkeypatch.delattr(program, "obs")
    monkeypatch.setitem(sys.modules, "diffusion_extensions_tpu_torch.obs", None)
    assert _read(name, TRAIN) is None


def _run():
    # float32 program: at these sizes bf16's gaps are not the cell's own
    return cell.run(CELL, SEED, 0.5, False, "cpu", time.perf_counter(), _cfg(bf16=False))["result"]


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


@pytest.mark.parametrize("fault", ["top_k_minus_one", "not_renormalised", "state_not_carried", "decay_dropped"])
def test_program_fault_is_not_correct(fault):
    with files.family("planenet_kimi").routing_fault(fault):
        result = _run()
    assert not result["correct"], result["checks"]
