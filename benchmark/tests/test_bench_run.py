"""The runner's refusals: no card, or JAX loaded."""
import os
import subprocess
import sys

from benchmark import run
from benchmark.harness import files


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "aircraft-train", "--seed",
                          "3000000000", "--seconds", "1"], capture_output=True, text=True, cwd=files.ROOT,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_forbidden_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "diffusion_extensions_tpu_torch_fake", sys)
    assert run.forbidden_modules() == [] or all(m.split(".")[0] in run.FORBIDDEN for m in run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "diffusion_extensions_tpu.ops", sys)
    assert {"jax.numpy", "diffusion_extensions_tpu.ops"} <= set(run.forbidden_modules())
    assert "diffusion_extensions_tpu_torch_fake" not in run.forbidden_modules()
