"""CUDA kernel for the batched LQT combine (paper eq. 42): build, binding
and wrapper.

The kernel (``csrc/lqt_combine.cu``) replaces the Pallas TPU kernel
``repro/kernels/lqt_combine/kernel.py::lqt_combine_lanes``: one thread per
element pair, lane-major operands, an unpivoted in-register Gauss-Jordan
inverse.  The source's header says what bounds it on an H100 and what the
design does about that.

Build: at first use, ``nvcc`` compiles the source for ``sm_90a`` into a
shared library with a plain C interface under ``build/repro_torch/`` at
the repository root (``.gitignore`` lists ``build/``), named by a hash of
the source and flags so that an edited source is rebuilt; ``ctypes``
loads it.  Nothing is built or imported from CUDA while this module is
imported.

The wrapper :func:`lqt_combine_lanes` runs the plain version
(:func:`.ref.lqt_combine_lanes_ref`) only for tensors on the CPU.  For CUDA
tensors it launches the kernel or raises; it never falls back.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from .._build import BUILD_DIR, compile_library, parse_ptxas  # noqa: F401
from .ref import lqt_combine_lanes_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "lqt_combine.cu"
MAX_NX = 8
_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}
_MAT = (True, False, True, False, True)     # A, b, C, eta, J

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
    """Registers and spills per kernel instantiation from ``-Xptxas -v``."""
    rows = parse_ptxas(
        log, r"lqt_combine_kernelILi(\d+)E([fd])E",
        lambda m: {"nx": int(m.group(1)),
                   "dtype": "float32" if m.group(2) == "f" else "float64"})
    return sorted(rows, key=lambda r: (r["dtype"], r["nx"]))


def build() -> dict:
    """Compile (if needed) and load the kernel library.

    Returns ``{"library", "seconds", "cached", "ptxas"}``: the build time
    (0 when a library of the same source and flags was already built) and
    the registers/spills ``ptxas`` reported per instantiation.
    """
    global _lib, _build_info
    if _build_info is not None:
        return _build_info
    lib, info = compile_library("lqt_combine", SOURCE)
    fn = lib.lqt_combine_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_void_p),
                   ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _lib = lib
    _build_info = {"library": info["library"], "seconds": info["seconds"],
                   "cached": info["cached"],
                   "ptxas": _parse_ptxas(info["log"])}
    return _build_info


def _check(ops1, ops2, block_size: int) -> None:
    ops = tuple(ops1) + tuple(ops2)
    if len(ops) != 10:
        raise ValueError("lqt_combine_lanes takes two 5-tuples (A, b, C, "
                         "eta, J)")
    A = ops[0]
    if A.dtype not in _DTYPE_CODES:
        raise TypeError(f"lqt_combine kernel takes float32 or float64, "
                        f"got {A.dtype}")
    if A.dim() != 3 or A.shape[0] != A.shape[1]:
        raise ValueError(f"A must be (nx, nx, B), got {tuple(A.shape)}")
    nx, B = A.shape[0], A.shape[2]
    if not 1 <= nx <= MAX_NX:
        raise ValueError(f"lqt_combine kernel takes 1 <= nx <= {MAX_NX}, "
                         f"got {nx}")
    for k, x in enumerate(ops):
        want = (nx, nx, B) if _MAT[k % 5] else (nx, B)
        if tuple(x.shape) != want:
            raise ValueError(f"operand {k} must be {want}, got "
                             f"{tuple(x.shape)}")
        if x.dtype != A.dtype or x.device != A.device:
            raise ValueError(f"operand {k} is {x.dtype} on {x.device}; all "
                             f"operands must be {A.dtype} on {A.device}")
        if not x.is_contiguous():
            raise ValueError(f"operand {k} is not contiguous (lane-major "
                             f"operands must be dense)")
    if not (isinstance(block_size, int) and 32 <= block_size <= 256
            and block_size % 32 == 0):
        raise ValueError(f"block_size must be a multiple of 32 in "
                         f"[32, 256], got {block_size!r}")


def lqt_combine_lanes(ops1, ops2, *, block_size: int = 128):
    """Batched eq.-(42) combine in lane-major layout.

    ``ops1``/``ops2``: tuples (A, b, C, eta, J) with shapes (nx, nx, B) /
    (nx, B), contiguous, one dtype and device.  CUDA tensors run the CUDA
    kernel with ``block_size`` threads per block on the current stream;
    CPU tensors run the plain version.
    """
    if ops1[0].device.type == "cpu":
        return lqt_combine_lanes_ref(ops1, ops2)
    if ops1[0].device.type != "cuda":
        raise ValueError(f"lqt_combine kernel runs on CUDA tensors, got "
                         f"{ops1[0].device}")
    _check(ops1, ops2, block_size)
    outs = tuple(torch.empty_like(x) for x in ops1)
    nx, B = ops1[0].shape[0], ops1[0].shape[-1]
    if B == 0:           # a grid of zero blocks is a launch error
        return outs
    build()
    ins = (ctypes.c_void_p * 10)(*(x.data_ptr() for x in (*ops1, *ops2)))
    dst = (ctypes.c_void_p * 5)(*(x.data_ptr() for x in outs))
    device = ops1[0].device
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _lib.lqt_combine_launch(_DTYPE_CODES[ops1[0].dtype], nx, ins,
                                      dst, B, block_size, stream)
    if err:
        raise RuntimeError(f"lqt_combine kernel launch failed with CUDA "
                           f"error {err} (nx={nx}, B={B}, "
                           f"block_size={block_size})")
    global _launches
    _launches += 1
    return outs
