"""CUDA kernel for a whole inclusive scan of LQT elements in one launch:
build, binding and wrapper.

The kernel (``csrc/lqt_scan.cu``) runs the eq.-(42) scan that the JAX
package drives through the Pallas kernel
``repro/kernels/lqt_combine/kernel.py::lqt_combine_lanes`` one tree level
at a time (``repro/kernels/lqt_combine/ops.py::kernel_suffix_scan``): every
level of the tree and every record in one cooperative launch, reading and
writing the elements in their natural ``(n, *R, nx, nx)`` / ``(n, *R, nx)``
layout.  It shares the combine's device code with the pairwise kernel
(``csrc/lqt_combine.cuh``); its source header says which tree levels take
which form of it and what bounds it.

Build: at first use, like the pairwise kernel (``kernel.py``), into
``build/repro_torch/`` at the repository root, named by a hash of the
source, the headers it includes and the flags.

:func:`lqt_scan` runs the plain version (:func:`.ref.lqt_scan_ref`, the
same tree in the same combine order) only for tensors on the CPU.  For CUDA
tensors it launches the kernel or raises; it never falls back.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch.core.types import LQTElement

from .._build import compile_library, parse_ptxas
from .kernel import _DTYPE_CODES, _MAT, MAX_NX
from .ref import lqt_scan_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "lqt_scan.cu"

_lib: Optional[ctypes.CDLL] = None
_build_info: Optional[dict] = None
_launches = 0
# grid size, resident blocks per SM and shared memory per block of the
# last launch (for reports)
last_launch: dict = {}


def launch_count() -> int:
    """Scan-kernel launches since the last :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def _parse_ptxas(log: str) -> list:
    """Registers and spills per kernel instantiation from ``-Xptxas -v``."""
    rows = parse_ptxas(
        log, r"lqt_scan_kernelILi(\d+)E([fd])E",
        lambda m: {"nx": int(m.group(1)),
                   "dtype": "float32" if m.group(2) == "f" else "float64"})
    return sorted(rows, key=lambda r: (r["dtype"], r["nx"]))


def build() -> dict:
    """Compile (if needed) and load the scan library.

    Returns ``{"library", "seconds", "cached", "ptxas"}`` as
    :func:`.kernel.build` does.
    """
    global _lib, _build_info
    if _build_info is not None:
        return _build_info
    lib, info = compile_library("lqt_scan", SOURCE)
    fn = lib.lqt_scan_launch
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    i64s = ctypes.POINTER(ctypes.c_int64)
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                   ctypes.c_int64, ptrs, i64s, ptrs, i64s, ptrs, ctypes.c_int,
                   ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    _lib = lib
    _build_info = {"library": info["library"], "seconds": info["seconds"],
                   "cached": info["cached"],
                   "ptxas": _parse_ptxas(info["log"])}
    return _build_info


def tree_depth(n: int) -> int:
    """``L = floor(log2 n)``: the kernel runs L down phases and
    ``max(L, 1)`` up phases (n >= 1)."""
    return n.bit_length() - 1


def scratch_elements(n: int, records: int) -> int:
    """Elements of tree levels 1..L the kernel keeps in its scratch."""
    return records * sum(n >> l for l in range(1, tree_depth(n) + 1))


def _check(elems: LQTElement) -> tuple:
    """``(n, record shape, nx)`` of valid scan input, else raise."""
    if len(tuple(elems)) != 5:
        raise ValueError("lqt_scan takes an LQTElement (A, b, C, eta, J)")
    A = elems[0]
    if A.dtype not in _DTYPE_CODES:
        raise TypeError(f"lqt_scan kernel takes float32 or float64, got "
                        f"{A.dtype}")
    if A.dim() < 3 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"A must be (n, *R, nx, nx), got {tuple(A.shape)}")
    nx = A.shape[-1]
    if not 1 <= nx <= MAX_NX:
        raise ValueError(f"lqt_scan kernel takes 1 <= nx <= {MAX_NX}, got "
                         f"{nx}")
    lead = tuple(A.shape[:-2])
    for k, x in enumerate(elems):
        want = lead + ((nx, nx) if _MAT[k] else (nx,))
        if tuple(x.shape) != want:
            raise ValueError(f"operand {k} must be {want}, got "
                             f"{tuple(x.shape)}")
        if x.dtype != A.dtype or x.device != A.device:
            raise ValueError(f"operand {k} is {x.dtype} on {x.device}; all "
                             f"operands must be {A.dtype} on {A.device}")
    return lead[0], lead[1:], nx


def _natural(x: torch.Tensor, n: int, R: int, mat: bool):
    """``(view, element stride, record stride)`` of one part viewed as
    ``(n, R, nx[, nx])`` with dense trailing dims, in values.

    Elements made by ordinary ops (the estimation paths' among them) are
    such views already; an operand whose trailing dims are not dense, or
    whose record dims cannot be merged into one stride, is made dense
    first (the one case that copies)."""
    inner = x.shape[x.dim() - (2 if mat else 1):]
    try:
        v = x.view((n, R) + tuple(inner))
    except RuntimeError:
        v = None
    if v is None or not _dense_inner(v, mat):
        v = x.contiguous().view((n, R) + tuple(inner))
    return v, v.stride(0), v.stride(1)


def _dense_inner(v: torch.Tensor, mat: bool) -> bool:
    nx = v.shape[-1]
    if nx > 1 and v.stride(-1) != 1:
        return False
    return not (mat and nx > 1 and v.stride(-2) != nx)


def lqt_scan(elems: LQTElement, *, reverse: bool = False,
             block_size: int = 128) -> LQTElement:
    """Inclusive scan of ``elems`` along axis 0, earlier operand first, in
    one kernel launch; ``reverse`` gives the suffix scan
    ``out[i] = a_i (x) ... (x) a_{n-1}``.

    ``elems``: ``(n, *R, nx, nx)`` / ``(n, *R, nx)`` of one dtype and
    device; records ``*R`` ride along in the same launch.  CUDA tensors run
    the kernel with ``block_size`` threads per block on the current stream
    and return new tensors in the natural layout; CPU tensors run the plain
    version.
    """
    device = elems[0].device
    if device.type == "cpu":
        return lqt_scan_ref(elems, reverse=reverse)
    if device.type != "cuda":
        raise ValueError(f"lqt_scan kernel runs on CUDA tensors, got "
                         f"{device}")
    n, rec, nx = _check(elems)
    if not (isinstance(block_size, int) and 32 <= block_size <= 256
            and block_size % 32 == 0):
        raise ValueError(f"block_size must be a multiple of 32 in "
                         f"[32, 256], got {block_size!r}")
    R = math.prod(rec)
    outs = LQTElement(*(torch.empty_like(x, memory_format=torch.contiguous_format)
                        for x in elems))
    if n == 0 or R == 0:
        return outs
    build()
    ins = [_natural(x, n, R, m) for x, m in zip(elems, _MAT)]
    dsts = [_natural(x, n, R, m) for x, m in zip(outs, _MAT)]
    S = scratch_elements(n, R)
    sizes = [S * (nx * nx if m else nx) for m in _MAT]
    scratch = torch.empty(sum(sizes), dtype=elems[0].dtype, device=device)
    parts = torch.split(scratch, sizes) if S else [scratch] * 5

    def ptrs(ts):
        return (ctypes.c_void_p * 5)(*(t.data_ptr() for t in ts))

    def strides(views):
        return (ctypes.c_int64 * 10)(*(v[1] for v in views),
                                     *(v[2] for v in views))

    info = (ctypes.c_int * 3)()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _lib.lqt_scan_launch(
            _DTYPE_CODES[elems[0].dtype], nx, int(reverse), n, R,
            ptrs(v[0] for v in ins), strides(ins), ptrs(v[0] for v in dsts),
            strides(dsts), ptrs(parts), block_size, stream, info)
    if err:
        raise RuntimeError(f"lqt_scan kernel launch failed with CUDA error "
                           f"{err} (nx={nx}, n={n}, R={R}, "
                           f"block_size={block_size})")
    global _launches, last_launch
    _launches += 1
    last_launch = {"grid": info[0], "blocks_per_sm": info[1],
                   "smem_bytes": info[2]}
    return outs
