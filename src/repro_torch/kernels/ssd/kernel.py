"""CUDA chunked-SSD kernel: build, binding and wrapper.

The kernel (``csrc/ssd.cu``) replaces the Pallas TPU kernel
``repro/kernels/ssd/kernel.py::ssd_chunked``; the source's header says
what bounds it on an H100 and what the design does about that.  It is
built at first use by ``nvcc`` into ``build/repro_torch/`` and loaded with
``ctypes`` (``kernels/_build.py``); nothing is built while this module is
imported.

The wrapper :func:`ssd_chunked` runs the plain version
(:func:`.ref.ssd_chunked_ref`) only for tensors on the CPU.  For CUDA
tensors it launches the kernel or raises; it never falls back.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from .._build import bf16_or_f32, compile_library, parse_ptxas
from .ref import ssd_chunked_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd.cu"
HEAD_DIMS = (8, 16, 32, 64, 128)
MAX_STATE = 128
MAX_CHUNK = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lib: Optional[ctypes.CDLL] = None
_build_info: Optional[dict] = None
_launches = 0


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def _parse_ptxas(log: str) -> list:
    rows = parse_ptxas(
        log, r"ssd_chunk_kernelILi(\d+)E(f|13__nv_bfloat16)E",
        lambda m: {"P": int(m.group(1)), "dtype": bf16_or_f32(m.group(2))})
    return sorted(rows, key=lambda r: (r["dtype"], r["P"]))


def build() -> dict:
    """Compile (if needed) and load the kernel library.

    Returns ``{"library", "seconds", "cached", "ptxas"}`` (build time, 0
    when already built, and registers/spills per instantiation).
    """
    global _lib, _build_info
    if _build_info is not None:
        return _build_info
    lib, info = compile_library("ssd", SOURCE)
    fn = lib.ssd_chunked_launch
    fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _lib = lib
    _build_info = {"library": info["library"], "seconds": info["seconds"],
                   "cached": info["cached"],
                   "ptxas": _parse_ptxas(info["log"])}
    return _build_info


def _check(l, dtx, B, C, chunk: int) -> None:
    if l.dtype != torch.float32:
        raise TypeError(f"l must be float32, got {l.dtype}")
    if dtx.dtype not in _DTYPE_CODES:
        raise TypeError(f"ssd kernel takes float32 or bfloat16 operands, got "
                        f"{dtx.dtype}")
    if dtx.dim() != 3 or l.dim() != 2 or B.dim() != 3:
        raise ValueError("l must be (BH, L), dtx (BH, L, P), B and C "
                         "(BH, L, S)")
    BH, L, P = dtx.shape
    S = B.shape[-1]
    if tuple(l.shape) != (BH, L):
        raise ValueError(f"l must be {(BH, L)}, got {tuple(l.shape)}")
    for name, x in (("B", B), ("C", C)):
        if tuple(x.shape) != (BH, L, S):
            raise ValueError(f"{name} must be {(BH, L, S)}, got "
                             f"{tuple(x.shape)}")
        if x.dtype != dtx.dtype:
            raise ValueError(f"{name} is {x.dtype}; dtx is {dtx.dtype}")
    if P not in HEAD_DIMS:
        raise ValueError(f"ssd kernel takes P in {HEAD_DIMS}, got {P}")
    if not 1 <= S <= MAX_STATE:
        raise ValueError(f"ssd kernel takes 1 <= S <= {MAX_STATE}, got {S}")
    if not (isinstance(chunk, int) and 1 <= chunk <= MAX_CHUNK):
        raise ValueError(f"ssd kernel takes 1 <= chunk <= {MAX_CHUNK}, got "
                         f"{chunk!r}")
    if L % chunk:
        raise ValueError(f"L={L} must be a multiple of chunk={chunk}")
    for name, x in (("l", l), ("dtx", dtx), ("B", B), ("C", C)):
        if x.device != dtx.device:
            raise ValueError(f"{name} is on {x.device}; dtx is on "
                             f"{dtx.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ssd_chunked(l, dtx, B, C, *, chunk: int = 128):
    """Chunked SSD scan.

    Args:
      l:   (BH, L) float32  log decays dt*A (<= 0)
      dtx: (BH, L, P)       dt-weighted inputs
      B:   (BH, L, S)
      C:   (BH, L, S)
    Returns:
      y: (BH, L, P) in dtx's dtype.  CUDA tensors run the kernel on the
      current stream; CPU tensors run the plain version.
    """
    if dtx.device.type == "cpu":
        if dtx.shape[1] % chunk:
            raise ValueError(f"L={dtx.shape[1]} must be a multiple of "
                             f"chunk={chunk}")
        return ssd_chunked_ref(l, dtx, B, C, chunk=chunk)
    if dtx.device.type != "cuda":
        raise ValueError(f"ssd kernel runs on CUDA tensors, got "
                         f"{dtx.device}")
    _check(l, dtx, B, C, chunk)
    BH, L, P = dtx.shape
    y = torch.empty_like(dtx)
    if y.numel() == 0:            # a grid of zero blocks is a launch error
        return y
    build()
    stream = torch.cuda.current_stream(dtx.device).cuda_stream
    with torch.cuda.device(dtx.device):
        err = _lib.ssd_chunked_launch(
            _DTYPE_CODES[dtx.dtype], P, l.data_ptr(), dtx.data_ptr(),
            B.data_ptr(), C.data_ptr(), y.data_ptr(), BH, L, B.shape[-1],
            chunk, stream)
    if err:
        raise RuntimeError(f"ssd kernel launch failed with CUDA error {err} "
                           f"(dtx {tuple(dtx.shape)}, S={B.shape[-1]}, "
                           f"chunk={chunk}, {dtx.dtype})")
    global _launches
    _launches += 1
    return y
