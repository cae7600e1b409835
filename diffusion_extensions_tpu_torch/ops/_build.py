"""Build of the port's CUDA kernels: ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes``.

Each source under ``csrc/`` is compiled for sm_90a at first use, into
``build/`` beside this package, under a name keyed by the hash of the source
and its flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.  The build runs on the machine with the card only.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "build_library"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def build_library(source: Path, extra_flags=()) -> tuple[ctypes.CDLL, str]:
    """Compile ``source`` (unless this source with these flags was built
    before) and load it.  Returns the library and nvcc's output ("" when
    the library was already built)."""
    flags = (*NVCC_FLAGS, *extra_flags)
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{source.stem}_{digest}.so"
    log = ""
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        res = subprocess.run([_nvcc(), *flags, "-o", str(tmp), str(source)],
                             capture_output=True, text=True)
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name} ({res.returncode}):\n{log}")
        os.replace(tmp, lib_path)
    return ctypes.CDLL(str(lib_path)), log
