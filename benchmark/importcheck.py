"""What the benchmark loads: no JAX, jaxlib or flax, and nothing of the
JAX package (``diffusion_extensions_tpu``), compared by whole top-level
names, so that the port (``diffusion_extensions_tpu_torch``) is not
matched; and nothing of the program under ``benchmark/reference/``.

    python3 benchmark/importcheck.py

imports every module of the runner, the loops, the families, the
metric readers and the reference in a fresh process and prints what it
found; it exits non-zero if anything is forbidden."""
from __future__ import annotations

import ast
import glob
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "diffusion_extensions_tpu")
PROGRAM = "diffusion_extensions_tpu_torch"


def forbidden(module_names) -> list:
    return sorted({m for m in module_names if m.split(".")[0] in FORBIDDEN})


def benchmark_modules() -> list:
    """Dotted names of every module under ``benchmark/`` but the tests."""
    out = []
    for path in sorted(glob.glob(os.path.join(HERE, "**", "*.py"), recursive=True)):
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        if ".tests." in rel or rel.endswith("conftest") or os.sep + "metrics" + os.sep in path:
            continue
        out.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    return out


def static_imports(path: str) -> set:
    """Top-level names a source file imports (relative imports left out)."""
    names = set()
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def reference_imports() -> dict:
    """{file: top-level names} for ``benchmark/reference/``."""
    return {p: static_imports(p) for p in sorted(glob.glob(os.path.join(HERE, "reference", "*.py")))}


_PROBE = """
import importlib, importlib.util, glob, json, os, sys
sys.path.insert(0, {root!r})
for name in {mods!r}:
    importlib.import_module(name)
for path in sorted(glob.glob(os.path.join({here!r}, "metrics", "*.py"))):
    spec = importlib.util.spec_from_file_location("m_" + os.path.basename(path)[:-3].replace(".", "_"), path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
import diffusion_extensions_tpu_torch.experiments.aircraft, diffusion_extensions_tpu_torch.experiments.protein
print(json.dumps(sorted(sys.modules)))
"""


def loaded_modules() -> list:
    """Every module loaded in a fresh process by importing all of the
    benchmark's modules, the metric readers and the experiment modules it builds
    through."""
    code = _PROBE.format(root=ROOT, here=HERE, mods=benchmark_modules())
    env = dict(os.environ, USE_FLAX="0")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, check=True)
    import json

    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    bad = forbidden(loaded_modules())
    ref = {p: sorted(n for n in names if n in FORBIDDEN or n == PROGRAM)
           for p, names in reference_imports().items()}
    ref = {p: n for p, n in ref.items() if n}
    print(f"forbidden modules loaded: {bad or 'none'}; reference files importing the program: {ref or 'none'}")
    return 1 if bad or ref else 0


if __name__ == "__main__":
    sys.exit(main())
