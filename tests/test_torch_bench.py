"""The port's headline measurement (``diffusion_extensions_tpu_torch/bench.py``,
``bench_torch.py``) against the JAX package's ``bench.py``, on the CPU at a
tiny configuration: the JSON line's keys and each row's keys are
``bench.py``'s (read from its source), every row's numbers are finite and
> 0, FlopCounterMode's count of a forward equals the closed form of
``flops.py`` exactly and a train step's is ~3x it, the regression check
reads only the port's ``BENCH_TORCH_r*.json``, and no TPU figure is in
the port."""
import ast
import json
import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from diffusion_extensions_tpu_torch import bench
from diffusion_extensions_tpu_torch.data.pdb import pad_prot_batch, synthetic_prot_pair, to_device
from diffusion_extensions_tpu_torch.experiments import aircraft, protein
from diffusion_extensions_tpu_torch.flops import moe_capacity, planenet_flops, protein_flops
from diffusion_extensions_tpu_torch.models.planenet import PlaneNet
from diffusion_extensions_tpu_torch.models.protnet import ProtNet
from diffusion_extensions_tpu_torch.parallel.dp import make_dp_train_step
from diffusion_extensions_tpu_torch.processes.se3 import ProjectedSE3Diffusion
from diffusion_extensions_tpu_torch.processes.so3 import ProjectedSO3Diffusion
from diffusion_extensions_tpu_torch.train.optim import make_optimizer
from diffusion_extensions_tpu_torch.train.state import TrainState

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--dim", "32", "--heads", "2", "--layers", "1", "--batch", "4",
        "--samples", "16", "--steps", "16", "--warmup", "8"]
# a train step's products against its forward's: the backward takes two
# products a forward product, less the input gradients nothing needs (the
# first layers' inputs are data): measured 2.9997-2.99995 for PlaneNet,
# 2.986-2.9995 for ProtNet
STEP_RATIO = (2.95, 3.0)


def _bench_py():
    with open(os.path.join(ROOT, "bench.py")) as f:
        return ast.parse(f.read())


def _function(tree, name):
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)


def _dict_keys(node) -> set:
    return {k.value for k in node.keys if isinstance(k, ast.Constant)}


def bench_py_keys():
    """(the JSON line's keys, {row: its keys}) of bench.py's ``main``; the
    protein rows' name is an f-string over b in (4, 16, 32)."""
    top, rows = set(), {}
    for node in ast.walk(_function(_bench_py(), "main")):
        if not isinstance(node, ast.Assign):
            continue
        target = node.targets[0]
        if isinstance(target, ast.Name) and target.id == "result" and \
                isinstance(node.value, ast.Dict):
            top |= _dict_keys(node.value)
        elif isinstance(target, ast.Subscript) and isinstance(target.value, ast.Name):
            if target.value.id == "result":
                top.add(target.slice.value)
            elif target.value.id == "rows" and isinstance(node.value, ast.Dict):
                if isinstance(target.slice, ast.Constant):
                    rows[target.slice.value] = _dict_keys(node.value)
                else:
                    for b in (4, 16, 32):
                        rows[f"protein_train_b{b}"] = _dict_keys(node.value)
    return top, rows


def regression_keys() -> set:
    fn = _function(_bench_py(), "_regression_check")
    ret = [n for n in ast.walk(fn) if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)]
    return _dict_keys(ret[0].value)


@pytest.fixture(scope="module")
def tiny_run():
    """``bench.main`` at a tiny configuration on the CPU, ``--quick``."""
    saved = (bench.PROTEIN_NET, bench.TIMESTEPS, bench.SAMPLER_CHAINS, bench.MMD_N_QUICK)
    bench.PROTEIN_NET = dict(dim=32, heads=2, t_depth=1, c_depth=3)
    bench.TIMESTEPS, bench.SAMPLER_CHAINS, bench.MMD_N_QUICK = 50, 16, 200
    try:
        return bench.main(["--quick"] + TINY)
    finally:
        bench.PROTEIN_NET, bench.TIMESTEPS, bench.SAMPLER_CHAINS, bench.MMD_N_QUICK = saved


def test_json_line_keys(tiny_run):
    """bench.py's keys (less the regression fields, present only with a
    previous record, and ``mfu_approx``, only with --no-bf16) plus
    ``peak`` and ``device``; the CPU's run names its device and claims no
    peak and no mfu."""
    top, rows = bench_py_keys()
    assert {"metric", "value", "unit", "vs_baseline", "mfu", "gflops_per_step", "rows",
            "mfu_approx", "quick"} <= top
    assert set(tiny_run) == top - {"mfu_approx"} | {"peak", "device"}
    assert set(tiny_run["rows"]) == set(rows) and len(rows) == 11
    assert tiny_run["device"] == "cpu" and tiny_run["peak"] is None and tiny_run["mfu"] is None
    assert tiny_run["quick"] is True
    assert tiny_run["value"] > 0 and tiny_run["gflops_per_step"] > 0
    assert tiny_run["vs_baseline"] == tiny_run["value"] / bench.REF_GPU_STEPS_PER_SEC


@pytest.mark.parametrize("row", sorted(bench_py_keys()[1]))
def test_row(tiny_run, row):
    """Each row: bench.py's keys, every number finite and > 0 (``mfu`` is
    None off the card); the mmd row at the quick size, the samplers' chains
    at the configured count, Picard's sweeps between 1 and 50."""
    want = bench_py_keys()[1][row]
    got = tiny_run["rows"][row]
    assert set(got) == want
    for key, v in got.items():
        if key == "mfu":
            assert v is None
            continue
        assert isinstance(v, (int, float)) and math.isfinite(v) and v > 0, (key, v)
    if row == "mmd_eval":
        assert got["n_samples"] == 200
    if "chains" in got:
        assert got["chains"] == 16
    if row == "ddim_50_picard":
        assert isinstance(got["sweeps"], int) and 1 <= got["sweeps"] <= 50


def test_flags_are_bench_pys():
    def flags(source):
        return set(re.findall(r'add_argument\(\s*"(--?[\w-]+)"', source))

    with open(os.path.join(ROOT, "bench.py")) as f:
        jax_flags = flags(f.read())
    with open(bench.__file__) as f:
        assert flags(f.read()) == jax_flags | {"--device"}
    args = bench.parse_args(["--quick"])
    assert (args.steps, args.warmup, args.steps_per_call, args.bf16) == (80, 24, 8, True)
    assert bench.parse_args(["--no-bf16"]).bf16 is False


def _count(fn) -> float:
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


@pytest.mark.parametrize("experts", [0, 4])
@pytest.mark.parametrize("dim,layers,batch,points", [(32, 1, 2, 8), (64, 2, 3, 16)])
def test_planenet_flops_closed_form(dim, layers, batch, points, experts):
    """FlopCounterMode's count of one PlaneNet forward equals
    ``planenet_flops`` exactly, dense and with 4 experts (the E x C padded
    slots counted)."""
    torch.manual_seed(0)
    model = PlaneNet(dim, 2, layers, moe_experts=experts)
    x, t = torch.randn(batch, points, 3), torch.zeros(batch, dtype=torch.long)
    assert _count(lambda: model(x, t)) == planenet_flops(dim, layers, batch, points, experts)


def test_moe_capacity_is_the_layers():
    from diffusion_extensions_tpu_torch.models.moe import MoEFFN

    layer = MoEFFN(8, 4)
    for tokens in (1, 3, 16, 8192):
        assert moe_capacity(tokens, 4) == layer.width(tokens)
    assert moe_capacity(8192, 4) == 2560  # bench.py's moe_train_e4: 10,240 slots


@pytest.fixture(scope="module")
def prot_batch():
    rng = np.random.default_rng(0)
    return to_device(pad_prot_batch([synthetic_prot_pair(rng, 14 - 2 * i, 8 - i)
                                     for i in range(3)]), "cpu")


FLAG_SETS = {"reference": {}, "headline": dict(frame_pool=True, cross_depth=2, rel_frame=True,
                                               equiv_head=True)}


@pytest.mark.parametrize("flags", sorted(FLAG_SETS))
@pytest.mark.parametrize("dim,t_depth,c_depth", [(32, 1, 3), (64, 2, 4)])
def test_protein_flops_closed_form(prot_batch, dim, t_depth, c_depth, flags):
    """FlopCounterMode's count of one ProtNet forward equals
    ``protein_flops`` exactly, with bench.py's flags and with the headline
    flags."""
    torch.manual_seed(0)
    model = ProtNet(dim=dim, heads=2, t_depth=t_depth, c_depth=c_depth, **FLAG_SETS[flags])
    b, lr = prot_batch.receptor_mask.shape
    ll = prot_batch.ligand_mask.shape[1]
    t = torch.zeros(b, dtype=torch.long)
    assert _count(lambda: model(prot_batch, t)) == protein_flops(
        dim, t_depth, c_depth, b, lr, ll, **FLAG_SETS[flags])


def _state(model):
    opt = make_optimizer(model.named_parameters(), 1e-4)
    return TrainState(model, opt, torch.Generator().manual_seed(0)), opt


@pytest.mark.parametrize("experts", [0, 4])
def test_aircraft_step_flops_are_three_forwards(experts):
    torch.manual_seed(0)
    model = PlaneNet(32, 2, 1, moe_experts=experts)
    state, opt = _state(model)
    process = ProjectedSO3Diffusion(50, device="cpu")
    step = make_dp_train_step(aircraft.make_loss_fn(model, process), model, opt)
    ratio = bench.step_flops(step, state, torch.randn(4, 16, 3)) / planenet_flops(
        32, 1, 4, 16, experts)
    assert STEP_RATIO[0] <= ratio <= STEP_RATIO[1]
    assert state.step == 1


def test_protein_step_flops_are_three_forwards(prot_batch):
    torch.manual_seed(0)
    model = ProtNet(dim=32, heads=2, t_depth=1, c_depth=3)
    state, opt = _state(model)
    process = ProjectedSE3Diffusion(50, device="cpu")
    step = make_dp_train_step(protein.make_loss_fn(model, process), model, opt)
    b, lr = prot_batch.receptor_mask.shape
    ratio = bench.step_flops(step, state, prot_batch) / protein_flops(
        32, 1, 3, b, lr, prot_batch.ligand_mask.shape[1])
    assert STEP_RATIO[0] <= ratio <= STEP_RATIO[1]


def _write(path, record):
    with open(path, "w") as f:
        json.dump(record, f)


def test_regression_check_reads_only_the_ports_records(tmp_path, capsys):
    """A TPU record (BENCH_r09.json) beside the port's BENCH_TORCH_r01.json
    is never read; the newest BENCH_TORCH round wins; the fields are
    bench.py's; a wrapped record is unwrapped to its JSON line."""
    root = str(tmp_path)
    result = {"value": 110.0, "rows": {"bingham_train": {"steps_per_sec": 80.0},
                                       "mmd_eval": {"seconds": 0.002}}}
    _write(tmp_path / "BENCH_r09.json", {"value": 1000.0, "rows": {}})
    assert bench._regression_check(dict(result), root=root) == {}
    _write(tmp_path / "BENCH_TORCH_r01.json",
           {"value": 100.0, "rows": {"bingham_train": {"steps_per_sec": 100.0},
                                     "mmd_eval": {"seconds": 0.002}}})
    fields = bench._regression_check(dict(result), root=root)
    assert set(fields) == regression_keys()
    assert fields["prev_round"] == 1 and fields["prev_value"] == 100.0
    assert fields["delta_pct"] == 10.0 and fields["regression"] is False
    assert fields["row_regressions"] == {"bingham_train.steps_per_sec": -20.0}
    assert "BENCH_TORCH_r01" in capsys.readouterr().err
    line = json.dumps({"value": 120.0, "rows": {}})
    _write(tmp_path / "BENCH_TORCH_r02.json", {"n": 2, "tail": f"log noise\n{line}\n"})
    fields = bench._regression_check(dict(result), root=root)
    assert fields["prev_round"] == 2 and fields["regression"] is True


def test_no_tpu_figure_in_the_port():
    """No TPU v5e peak (197e12 bf16, 98.5e12 f32, 819 GB/s) in the port,
    its bench entry point or chip_smoke.py; the port's peaks are the H100
    data sheet's."""
    files = [os.path.join(ROOT, "bench_torch.py"), os.path.join(ROOT, "chip_smoke.py")]
    pkg = os.path.dirname(bench.__file__)
    for root, _, names in os.walk(pkg):
        files += [os.path.join(root, n) for n in names if n.endswith((".py", ".cu"))]
    pattern = re.compile(r"197e12|197\.0e12|98\.5e12|819e9|197 TFLOP")
    hits = []
    for path in files:
        with open(path) as f:
            hits += [path for line in f if pattern.search(line)]
    assert not hits
    assert (bench.PEAK_BF16, bench.PEAK_F32) == (989.4e12, 66.9e12)


def test_needs_a_card_unless_told_otherwise():
    """Without ``--device`` the entry point runs on the card; where there is
    none it raises and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, "bench_torch.py", "--headline-only"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and "no CUDA device" in res.stderr
    assert res.stdout.strip() == ""
