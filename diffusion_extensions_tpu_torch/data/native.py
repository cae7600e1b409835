"""ctypes binding of the native threaded batch loader
(``native/dataloader.cc`` at the repository's root; counterpart of
``diffusion_extensions_tpu/data/native.py``, the port's own copy).

The shared library is built with g++ at first use into the port's
``build/`` directory, under a name keyed by the hash of the source, so an
edited source is rebuilt.  ``NativeBatchLoader`` matches the
``BatchLoader`` iteration contract; worker threads assemble batches into a
bounded ring while the device computes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..ops._build import BUILD_DIR
from .shapenet import HostToDevice

__all__ = ["NativeBatchLoader", "build_native", "native_available"]

_SRC = Path(__file__).resolve().parents[2] / "native" / "dataloader.cc"
_lock = threading.Lock()
_lib = None


def build_native() -> str:
    """Compile the shared library from source unless this source was built
    before; returns its path."""
    with _lock:
        digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
        lib_path = BUILD_DIR / f"libdxtdata_{digest}.so"
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
            subprocess.run(
                ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                 "-o", str(tmp), str(_SRC), "-lpthread"],
                check=True, capture_output=True,
            )
            os.replace(tmp, lib_path)
        return str(lib_path)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build_native())
    lib.dl_create.restype = ctypes.c_void_p
    lib.dl_create.argtypes = [
        ctypes.c_void_p,  # data
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # n, points, dim
        ctypes.c_int64, ctypes.c_int64,  # batch, samples
        ctypes.c_int64, ctypes.c_uint64, ctypes.c_int64,  # threads, seed, cap
    ]
    lib.dl_next.restype = ctypes.c_int
    lib.dl_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.dl_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def native_available() -> bool:
    try:
        _load()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


class NativeBatchLoader:
    """Infinite iterator of (batch, samples, dim) float32 tensors on
    ``device`` (host tensors when it is ``None``), assembled by native
    worker threads.  The loader keeps ``data`` alive for its lifetime."""

    def __init__(
        self,
        data: np.ndarray,
        batch: int,
        samples: int | None = None,
        seed: int = 0,
        n_threads: int = 2,
        capacity: int = 4,
        device=None,
    ):
        lib = _load()
        self._data = np.ascontiguousarray(data, dtype=np.float32)
        n, points, dim = self._data.shape
        self.batch = batch
        self.samples = samples or points
        self.dim = dim
        self._put = HostToDevice(device)
        self._out = np.empty((batch, self.samples, dim), dtype=np.float32)
        self._handle = lib.dl_create(
            self._data.ctypes.data_as(ctypes.c_void_p),
            n, points, dim, batch, self.samples,
            n_threads, seed, capacity,
        )
        self._lib = lib

    def __iter__(self):
        return self

    def __next__(self):
        if self._handle is None:
            raise StopIteration("NativeBatchLoader is closed")
        ok = self._lib.dl_next(
            self._handle, self._out.ctypes.data_as(ctypes.c_void_p)
        )
        if not ok:  # loader stopping: output buffer was not written
            raise StopIteration("NativeBatchLoader stopped")
        return self._put(self._out.copy())

    def close(self):
        if self._handle is not None:
            self._lib.dl_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
