"""Build a kernel source with ``nvcc`` into a shared library and load it.

Every kernel of the port is CUDA C++ with a plain C interface, compiled at
first use for ``sm_90a`` into ``build/repro_torch/`` at the repository
root (``.gitignore`` lists ``build/``) and loaded with ``ctypes``.  The
library is named by a hash of the source, the headers it includes from its
own directory and the flags, so an edited source or header is rebuilt.
Nothing is compiled while a module is imported, and builds of different
kernels may run at the same time (each writes its own temporary file and
renames it into place).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc"))
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       "source and need the CUDA toolkit")


_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def local_headers(source: Path) -> list:
    """The headers ``source`` includes with ``#include "..."`` from its own
    directory, and theirs, each once, in the order first met."""
    seen, todo = [], [source]
    while todo:
        text = todo.pop(0).read_text()
        for name in _LOCAL_INCLUDE.findall(text):
            h = source.parent / name
            if h.is_file() and h not in seen:
                seen.append(h)
                todo.append(h)
    return seen


def source_digest(source: Path) -> str:
    """Hash of the source, its local headers (by name and content) and the
    flags: the build's name."""
    h = hashlib.sha256(source.read_bytes())
    for header in local_headers(source):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def compile_library(name: str, source: Path) -> tuple:
    """Compile ``source`` (if not already built) and load it.

    Returns ``(library, info)`` with ``info = {"library", "seconds",
    "cached", "log"}``: the build time (0 when a library of the same
    source, headers and flags was already built) and ptxas's ``-v``
    output.
    """
    digest = source_digest(source)
    so = BUILD_DIR / f"lib{name}_{digest}.so"
    log_path = so.with_suffix(".ptxas.txt")
    seconds, cached = 0.0, so.exists()
    if not cached:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {source}:\n"
                f"{proc.stdout}\n{proc.stderr}")
        log_path.write_text(proc.stderr)
        os.replace(tmp, so)
    log = log_path.read_text() if log_path.exists() else ""
    return ctypes.CDLL(str(so)), {"library": str(so), "seconds": seconds,
                                  "cached": cached, "log": log}


def parse_ptxas(log: str, entry: str, keys: Callable[[re.Match], dict]
                ) -> list:
    """Registers and spills per kernel instantiation from ``-Xptxas -v``.

    ``entry`` is a regex matched against each "Compiling entry function"
    line's mangled name; ``keys(match)`` names the instantiation.
    """
    rows, cur = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(entry, line)
            cur = keys(m) if m else None
            if cur is not None:
                rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"] = int(m.group(1))
            cur["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return rows


def bf16_or_f32(code: str) -> str:
    """The dtype of a mangled template argument: ``f`` or ``__nv_bfloat16``."""
    return "float32" if code == "f" else "bfloat16"
