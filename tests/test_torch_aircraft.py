"""The port's aircraft evaluation driver end to end on the CPU, at small
sizes, on synthetic clouds."""
import os

import numpy as np
import pytest
import torch

from diffusion_extensions_tpu_torch.data.shapenet import ShapeNet, synthetic_planes
from diffusion_extensions_tpu_torch.experiments import aircraft
from diffusion_extensions_tpu_torch.models.planenet import PlaneNet

torch.set_num_threads(1)
ARGS = ["--so3", "--test", "--device", "cpu", "--dim", "32", "--heads", "2",
        "--layers", "1", "--batch", "5", "--samples", "16", "--timesteps", "8",
        "--data-root", "/nonexistent"]


def test_aircraft_test_prints_percentile_table(tmp_path, capsys):
    ckpt = os.path.join(str(tmp_path), "aircraft_so3.pt")
    res = aircraft.main(ARGS + ["--ckpt", ckpt])
    out = capsys.readouterr().out
    assert "no checkpoint found" in out and "synthetic_planes" in out
    # all 128 synthetic test shapes, the last batch padded from 3 valid
    assert res.shape == (128 * aircraft.SAMPLES_PER_SHAPE,)
    assert np.isfinite(res).all() and (res >= 0).all() and (res <= np.pi + 1e-6).all()
    assert "percentiles & 1% & 5% & 10% & 50% & 90% & 95% & 99%" in out
    assert any(line.startswith("so3 & ") for line in out.splitlines())
    saved = np.load(os.path.join(str(tmp_path), "results_aircraft_so3.npy"))
    np.testing.assert_array_equal(saved, res)


def test_aircraft_test_loads_checkpoint(tmp_path, capsys):
    """A torch.save state dict at --ckpt is loaded (no warning), and the
    same seed gives the same samples.  --max-shapes stops after the batch
    that reaches it."""
    ckpt = os.path.join(str(tmp_path), "w.pt")
    torch.manual_seed(1)
    torch.save(PlaneNet(dim=32, heads=2, layers=1).state_dict(), ckpt)
    a = aircraft.main(ARGS + ["--ckpt", ckpt, "--max-shapes", "7"])
    b = aircraft.main(ARGS + ["--ckpt", ckpt, "--max-shapes", "7"])
    assert "no checkpoint found" not in capsys.readouterr().out
    assert a.shape == (10 * aircraft.SAMPLES_PER_SHAPE,)
    np.testing.assert_array_equal(a, b)


def test_data_matches_jax_package(tmp_path):
    """The synthetic clouds are the JAX package's; a missing ShapeNet
    raises; ``--tp`` (a training flag) leaves ``--test``'s samples as they
    are, as in the JAX driver."""
    from diffusion_extensions_tpu.data.shapenet import synthetic_planes as jplanes

    np.testing.assert_array_equal(synthetic_planes(3, 256, seed=2), jplanes(3, 256, seed=2))
    with pytest.raises(FileNotFoundError):
        ShapeNet("test", root="/nonexistent")
    args = ARGS + ["--ckpt", str(tmp_path / "w.pt"), "--max-shapes", "5"]
    np.testing.assert_array_equal(aircraft.main(args + ["--tp", "2"]), aircraft.main(args))
