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
import re
import shutil
import subprocess
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "build_library", "parse_sass", "sass_summary"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _cuda_tool(name: str) -> str | None:
    for cand in (shutil.which(name), f"/usr/local/cuda/bin/{name}"):
        if cand and os.path.exists(cand):
            return cand
    return None


def _nvcc() -> str:
    nvcc = _cuda_tool("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")
    return nvcc


def build_library(source: Path, extra_flags=()) -> tuple[ctypes.CDLL, str, Path]:
    """Compile ``source`` (unless this source with these flags was built
    before) and load it.  Returns the library, nvcc's output ("" when
    the library was already built) and the library's path."""
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
    return ctypes.CDLL(str(lib_path)), log, lib_path


_SASS_LINE = re.compile(r"^\s*/\*([0-9a-fA-F]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)\s*([^;]*);")
_SASS_FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)")


def _count(ops: list[str]) -> dict:
    def starts(*prefixes):
        return sum(op.startswith(prefixes) for op in ops)

    return {"instructions": len(ops), "mufu": starts("MUFU"),
            "fp32": starts("FFMA", "FMUL", "FADD"), "shared_loads": starts("LDS"),
            "ex2": sum(op.startswith("MUFU.EX2") for op in ops)}


def parse_sass(text: str) -> dict:
    """Per kernel of a ``cuobjdump -sass`` listing: the instruction counts
    of the whole function and of its hottest loop, the innermost loop (body
    of a backward branch that holds no other) with the most MUFU
    instructions (``None`` where the kernel has no loop).  Counts: all instructions, MUFU, FFMA/FMUL/FADD, LDS, and
    MUFU.EX2 (one per pair in the MMD kernel's loop)."""
    functions: dict[str, list[tuple[int, str, str]]] = {}
    current = None
    for line in text.splitlines():
        head = _SASS_FUNCTION.match(line)
        if head:
            current = functions.setdefault(head.group(1), [])
            continue
        m = _SASS_LINE.match(line)
        if m and current is not None:
            current.append((int(m.group(1), 16), m.group(2), m.group(3)))
    out = {}
    for name, instrs in functions.items():
        loops = []
        for addr, op, operands in instrs:
            target = re.search(r"0x([0-9a-fA-F]+)\s*$", operands.strip())
            if op.startswith("BRA") and target is not None and int(target.group(1), 16) <= addr:
                loops.append((int(target.group(1), 16), addr))
        best = None
        for start, end in loops:
            if any((s, e) != (start, end) and start <= s and e <= end for s, e in loops):
                continue  # holds another loop: not an innermost one
            counts = _count([o for a, o, _ in instrs if start <= a <= end])
            if best is None or (counts["mufu"], counts["instructions"]) > (
                    best["mufu"], best["instructions"]):
                best = counts
        out[name] = {**_count([o for _, o, _ in instrs]), "loop": best}
    return out


def sass_summary(lib_path) -> dict | None:
    """``parse_sass`` of a built library, or ``None`` where the machine has
    no ``cuobjdump`` (or it fails on the file)."""
    tool = _cuda_tool("cuobjdump")
    if tool is None or lib_path is None:
        return None
    res = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True)
    if res.returncode != 0:
        return None
    return parse_sass(res.stdout) or None
