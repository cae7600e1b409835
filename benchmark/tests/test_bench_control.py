"""The control at a size the CPU holds: the reference put in the
program's place in the precisions below the configuration's (fp8
products in the bf16 region; TF32 products in the sampler's float32
rotation steps) comes out not correct under each cell's limits, where the
program, in bf16 at the same size, comes out correct."""
import pytest

from benchmark import control
from benchmark.harness import compare, files

SIZES = {
    "aircraft-train": (dict(dim=128, heads=4, layers=2, batch=8, points=64, timesteps=1000), None),
    "protein-train": (dict(dim=64, heads=4, t_depth=2, c_depth=3, batch=4, receptor_len=24, ligand_len=12,
                           min_receptor_len=20, min_ligand_len=10, timesteps=1000), None),
    "protein-sample": (dict(dim=64, heads=4, t_depth=2, c_depth=3, batch=4, receptor_len=24, ligand_len=12,
                            min_receptor_len=20, min_ligand_len=10, timesteps=1000), dict(sampler_steps=4)),
}
CASES = [(cell, seed) for cell in SIZES for seed in (1, 2, 3)]


@pytest.mark.parametrize("cell,seed", CASES)
def test_control_is_not_correct(cell, seed):
    overrides, traffic = SIZES[cell]
    numbers = control.readings(cell, "control", seed, "cpu", overrides, traffic)
    limits = files.workload(cell)["limits"]
    assert any(numbers[k] > lim for k, lim in limits.items() if k in numbers), numbers


@pytest.mark.parametrize("cell,seed", CASES)
def test_program_is_correct_at_that_size(cell, seed):
    overrides, traffic = SIZES[cell]
    numbers = control.readings(cell, "program", seed, "cpu", overrides, traffic)
    assert compare.judge(numbers, files.workload(cell)["limits"]), numbers
