#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port, one run of one cell:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout on a machine with the cell's cards.  It
makes the cell's weights and inputs from the seed, builds the program
(``diffusion_extensions_tpu_torch``) through its experiments' own loss functions, warms
up every shape, runs the window for ``--seconds`` and compares what the
window's path produced with the plain reference (``benchmark/reference``).
The last line of standard output is the result: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and ``checks`` (each number compared, with its limit, also
the last lines of standard error).  Exits non-zero, with no result, when
the cards are missing or JAX or the JAX package was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# kernel and build caches at fixed places inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
          "TORCHINDUCTOR_CACHE_DIR": "inductor", "CUDA_CACHE_PATH": "cuda"}
FORBIDDEN = ("jax", "jaxlib", "flax", "diffusion_extensions_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (``diffusion_extensions_tpu_torch`` is another name)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def use_caches() -> None:
    """Every build and kernel cache of the program at its fixed place, and
    the bytecode of every module imported from here on, the libraries'
    too, written there even where the environment says to write none
    (compiling them again took some 5 s of each run's set-up)."""
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
        os.makedirs(os.environ[var], exist_ok=True)
    sys.pycache_prefix = os.path.join(ROOT, ".bench_cache", "pycache")
    sys.dont_write_bytecode = False


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    use_caches()
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from benchmark.harness import cell, files

    chips = files.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = cell.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    result = out["result"]
    print(f"card: {cell.power_limit()}", file=sys.stderr)
    print(f"setup phases (s): {json.dumps(out['setup_phases'])}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
