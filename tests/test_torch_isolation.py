"""The port and chip_smoke.py import neither JAX nor the JAX package.

A subprocess installs an import hook that refuses ``jax`` (and flax, optax,
orbax) and ``diffusion_extensions_tpu`` by exact name or by the
``diffusion_extensions_tpu.`` prefix -- the port's own name,
``diffusion_extensions_tpu_torch``, shares the string prefix and must pass.
It then imports every module of the port and ``chip_smoke.py``.
"""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, importlib.abc, importlib.util, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "diffusion_extensions_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        for b in BLOCKED:
            if name == b or name.startswith(b + "."):
                raise ImportError(f"blocked import: {name}")
        return None

sys.meta_path.insert(0, Block())
import diffusion_extensions_tpu_torch as port

names = [port.__name__]
for info in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    names.append(info.name)
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules
                if any(m == b or m.startswith(b + ".") for b in BLOCKED))
assert not leaked, leaked
print(" ".join(names))
print(len(names))
"""


def test_port_and_chip_smoke_import_no_jax():
    res = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=ROOT, capture_output=True, text=True,
        timeout=300,
    )
    assert res.returncode == 0, res.stderr
    # package + ops(8) + processes(4) + models(6) + data(5) + experiments(4) + convert
    # + train(4) + parallel(2)
    lines = res.stdout.strip().splitlines()
    assert int(lines[-1]) >= 35
    imported = set(lines[-2].split())
    pkg = "diffusion_extensions_tpu_torch"
    assert {f"{pkg}.train.optim", f"{pkg}.train.state", f"{pkg}.train.loop",
            f"{pkg}.parallel.dp", f"{pkg}.data.native", f"{pkg}.ops.se3", f"{pkg}.data.pdb",
            f"{pkg}.models.protnet", f"{pkg}.processes.se3",
            f"{pkg}.experiments.protein"} <= imported
