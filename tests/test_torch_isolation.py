"""The port, chip_smoke.py and bench_torch.py import neither JAX nor the JAX package, nor
matplotlib (the card's machine has none; the figures import it where they
draw).

A subprocess installs an import hook that refuses ``jax`` (and flax, optax,
orbax), matplotlib and ``diffusion_extensions_tpu`` by exact name or by the
``diffusion_extensions_tpu.`` prefix -- the port's own name,
``diffusion_extensions_tpu_torch``, shares the string prefix and must pass.
It then imports every module of the port, ``chip_smoke.py`` and
``bench_torch.py``.
"""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, importlib.abc, importlib.util, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "matplotlib", "diffusion_extensions_tpu")

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
for script in ("chip_smoke", "bench_torch"):
    spec = importlib.util.spec_from_file_location(script, script + ".py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules
                if any(m == b or m.startswith(b + ".") for b in BLOCKED))
assert not leaked, leaked
assert port.obs._launch is None and not port.obs.enabled()  # importing loads no stamp library
print(" ".join(names))
print(len(names))
"""


def test_port_and_chip_smoke_import_no_jax():
    res = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=ROOT, capture_output=True, text=True,
        timeout=300,
    )
    assert res.returncode == 0, res.stderr
    # package + ops(8) + processes(6) + models(8) + data(6) + experiments(10) + convert
    # + bench + flops + obs + sweep + train(4) + parallel(2) + viz(5)
    lines = res.stdout.strip().splitlines()
    assert int(lines[-1]) >= 54
    imported = set(lines[-2].split())
    pkg = "diffusion_extensions_tpu_torch"
    assert {f"{pkg}.train.optim", f"{pkg}.train.state", f"{pkg}.train.loop",
            f"{pkg}.parallel.dp", f"{pkg}.data.native", f"{pkg}.ops.se3", f"{pkg}.data.pdb",
            f"{pkg}.models.protnet", f"{pkg}.processes.se3",
            f"{pkg}.experiments.protein", f"{pkg}.processes.r3", f"{pkg}.processes.euler",
            f"{pkg}.experiments.so3_toy", f"{pkg}.experiments.lock",
            f"{pkg}.models.rot_predict", f"{pkg}.data.synthetic", f"{pkg}.models.coordconv",
            f"{pkg}.data.jigsaw", f"{pkg}.experiments.jigsaw", f"{pkg}.experiments.diagnostics",
            f"{pkg}.experiments.grad_check", f"{pkg}.viz", f"{pkg}.viz.colors", f"{pkg}.viz.mpl",
            f"{pkg}.viz.obj3d", f"{pkg}.viz.sphere", f"{pkg}.bench", f"{pkg}.flops",
            f"{pkg}.sweep", f"{pkg}.experiments.probe_protein", f"{pkg}.obs",
            f"{pkg}.models.deepseek_v2"} <= imported
