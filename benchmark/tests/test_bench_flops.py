"""The frozen FLOP forms against FlopCounterMode: a forward exactly, a
train step within a thousandth of 3 forwards (the first layers' input
gradients, which no input needs, are the difference)."""
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.flops import STEP_FORWARDS
from benchmark.harness import files, util
from benchmark.harness import weights as wts
from benchmark.tests import small


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def _cell(name, overrides, device):
    cfg = dict(files.config(files.workload(name)["config"]), **overrides)
    fam = files.family(cfg["family"])
    model = fam.build_model(cfg, wts.make(fam.param_spec(cfg), 1, device), device)
    _, loss_fn = fam.build_train(cfg, model, device)
    pool, _ = fam.train_inputs(cfg, 1, np.random.default_rng(0), device)
    batch = util.tree_map(lambda x: x[0], pool)
    t = torch.zeros(cfg["batch"], dtype=torch.long, device=device)
    x = batch if cfg["family"] == "protnet" else batch @ torch.eye(3, device=device)
    return cfg, fam, model, loss_fn, batch, x, t


def _check(name, overrides, device, step_tol):
    cfg, fam, model, loss_fn, batch, x, t = _cell(name, overrides, device)
    with torch.no_grad():
        fwd = _count(lambda: model(x, t))
    assert fwd == fam.forward_flops(cfg)
    step = _count(lambda: loss_fn(torch.Generator(device=device).manual_seed(0), batch).backward())
    assert 0 <= STEP_FORWARDS * fwd - step <= step_tol * step


@pytest.mark.parametrize("name", ["aircraft-train", "protein-train"])
@pytest.mark.parametrize("bf16", [False, True])
def test_small_on_cpu(name, bf16):
    overrides = dict(small.CELLS[name][0], bf16=bf16)
    _check(name, overrides, torch.device("cpu"), 5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["aircraft-train", "protein-train"])
def test_cells_own_shapes_on_the_card(name, card):
    _check(name, {}, card, 1e-3)
