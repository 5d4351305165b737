"""CUDA kernels for a whole inclusive scan of LQT elements: build,
binding and wrapper of each.

The register kernel (``csrc/lqt_scan.cu``) runs the eq.-(42) scan that the JAX
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

States wider than the register kernel's ``MAX_NX`` take the wide kernel
(``csrc/lqt_scan_wide.cu``, :func:`lqt_scan_wide`): the same tree, one
thread block per combine with its operands in shared memory, one launch
per tree level, for ``9 <= nx <= NX_WIDE``.

:func:`lqt_scan` and :func:`lqt_scan_wide` run the plain version
(:func:`.ref.lqt_scan_ref`, the same tree in the same combine order) only
for tensors on the CPU.  For CUDA tensors they launch their kernel or
raise; they never fall back.  Each launch counts, while telemetry is on,
under its kernel's counter (``repro_torch.obs``): ``scan.kernel.regs``
one a scan, ``scan.kernel.wide`` the launches the wide entry reports.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch import obs
from repro_torch.core.combine import lqt_combine as _core_combine
from repro_torch.core.types import LQTElement

from .._build import compile_library, parse_ptxas
from .kernel import _DTYPE_CODES, _MAT, MAX_NX
from .ref import lqt_scan_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "lqt_scan.cu"
WIDE_SOURCE = SOURCE.with_name("lqt_scan_wide.cu")
# shared memory one block of an H100 may have (dynamic, opt-in), and the
# widest state whose float64 combine fits in it (wide_smem_bytes)
SMEM_BYTES = 232448
NX_WIDE = 69
# threads of a wide kernel's block, which owns one combine (measured on an
# H100 at a fold step of 32768 pairs, nx = 40, float64: 12.6 ms against
# 15.6 ms with 128)
WIDE_THREADS = 256

_lib: Optional[ctypes.CDLL] = None
_build_info: Optional[dict] = None
_launches = 0
_wide_lib: Optional[ctypes.CDLL] = None
_wide_build_info: Optional[dict] = None
_wide_launches = 0
_pair_launches = 0
# grid size, resident blocks per SM and shared memory per block of the
# last launch (for reports)
last_launch: dict = {}


def launch_count() -> int:
    """Scan-kernel launches since the last :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def wide_launch_count() -> int:
    """Wide-kernel launches since the last :func:`reset_wide_launch_count`
    (:func:`wide_launches` a scan)."""
    return _wide_launches


def reset_wide_launch_count() -> None:
    global _wide_launches
    _wide_launches = 0


def pair_launch_count() -> int:
    """Launches of the wide kernel's pairwise entry (one a
    :func:`lqt_combine_wide` call) since :func:`reset_pair_launch_count`."""
    return _pair_launches


def reset_pair_launch_count() -> None:
    global _pair_launches
    _pair_launches = 0


def _parse_ptxas(log: str) -> list:
    """Registers and spills per kernel instantiation from ``-Xptxas -v``."""
    rows = parse_ptxas(
        log, r"lqt_scan_kernelILi(\d+)E([fd])E",
        lambda m: {"nx": int(m.group(1)),
                   "dtype": "float32" if m.group(2) == "f" else "float64"})
    return sorted(rows, key=lambda r: (r["dtype"], r["nx"]))


def _bind(fn) -> None:
    """Argument types of ``lqt_scan_launch`` and ``lqt_scan_wide_launch``."""
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    i64s = ctypes.POINTER(ctypes.c_int64)
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                   ctypes.c_int64, ptrs, i64s, ptrs, i64s, ptrs, ctypes.c_int,
                   ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int


def build() -> dict:
    """Compile (if needed) and load the scan library.

    Returns ``{"library", "seconds", "cached", "ptxas"}`` as
    :func:`.kernel.build` does.
    """
    global _lib, _build_info
    if _build_info is not None:
        return _build_info
    lib, info = compile_library("lqt_scan", SOURCE)
    _bind(lib.lqt_scan_launch)
    _lib = lib
    _build_info = {"library": info["library"], "seconds": info["seconds"],
                   "cached": info["cached"],
                   "ptxas": _parse_ptxas(info["log"])}
    return _build_info


def _parse_wide_ptxas(log: str) -> list:
    """Registers and spills of the wide kernel's two instantiations."""
    rows = parse_ptxas(
        log, r"lqt_scan_wide_kernelI([fd])E",
        lambda m: {"dtype": "float32" if m.group(1) == "f" else "float64"})
    return sorted(rows, key=lambda r: r["dtype"])


def build_wide() -> dict:
    """Compile (if needed) and load the wide kernel's library; returns
    what :func:`build` returns."""
    global _wide_lib, _wide_build_info
    if _wide_build_info is not None:
        return _wide_build_info
    lib, info = compile_library("lqt_scan_wide", WIDE_SOURCE)
    _bind(lib.lqt_scan_wide_launch)
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    i64s = ctypes.POINTER(ctypes.c_int64)
    fn = lib.lqt_combine_wide_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                   ptrs, i64s, ptrs, i64s, ptrs, i64s, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _wide_lib = lib
    _wide_build_info = {"library": info["library"],
                        "seconds": info["seconds"], "cached": info["cached"],
                        "ptxas": _parse_wide_ptxas(info["log"])}
    return _wide_build_info


def tree_depth(n: int) -> int:
    """``L = floor(log2 n)``: the kernel runs L down phases and
    ``max(L, 1)`` up phases (n >= 1)."""
    return n.bit_length() - 1


def scratch_elements(n: int, records: int) -> int:
    """Elements of tree levels 1..L the kernel keeps in its scratch."""
    return records * sum(n >> l for l in range(1, tree_depth(n) + 1))


def wide_launches(n: int) -> int:
    """Launches of the wide kernel for a scan of ``n >= 1`` elements: one
    per down phase and one per up phase that has combines, up phase 0
    always (it writes the outputs); 17 for ``n = 513``."""
    L = tree_depth(n)
    return L + sum(1 for l in range(max(L, 1))
                   if l == 0 or ((n >> l) - 1) // 2 > 0)


def wide_smem_bytes(nx: int, itemsize: int) -> int:
    """Shared memory of one wide combine (``smem_values`` in
    ``csrc/lqt_scan_wide.cu``): three ``nx x nx`` buffers and the
    ``nx x (3 nx + 1)`` system at odd row strides, three vectors and the
    pivot."""
    ld, lg = nx | 1, (3 * nx + 1) | 1
    return (3 * nx * ld + nx * lg + 3 * nx + 2) * itemsize


def _check(elems: LQTElement, lo: int = 1, hi: int = MAX_NX,
           name: str = "lqt_scan") -> tuple:
    """``(n, record shape, nx)`` of valid scan input, else raise."""
    if len(tuple(elems)) != 5:
        raise ValueError("lqt_scan takes an LQTElement (A, b, C, eta, J)")
    A = elems[0]
    if A.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} kernel takes float32 or float64, got "
                        f"{A.dtype}")
    if A.dim() < 3 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"A must be (n, *R, nx, nx), got {tuple(A.shape)}")
    nx = A.shape[-1]
    if not lo <= nx <= hi:
        raise ValueError(f"{name} kernel takes {lo} <= nx <= {hi}, got {nx}")
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


def _launch(elems: LQTElement, shape: tuple, reverse: bool,
            block_size: int, name: str, entry):
    """Outputs and scratch for a scan of ``shape = (n, rec, nx)``, then
    ``entry()`` (the bound C function, built at first use) on the current
    stream.  Returns ``(outputs, info)``; ``info`` is ``None`` when there
    was nothing to scan (and nothing was launched)."""
    n, rec, nx = shape
    if not (isinstance(block_size, int) and 32 <= block_size <= 256
            and block_size % 32 == 0):
        raise ValueError(f"block_size must be a multiple of 32 in "
                         f"[32, 256], got {block_size!r}")
    device = elems[0].device
    R = math.prod(rec)
    outs = LQTElement(*(torch.empty_like(x, memory_format=torch.contiguous_format)
                        for x in elems))
    if n == 0 or R == 0:
        return outs, None
    fn = entry()
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
        err = fn(_DTYPE_CODES[elems[0].dtype], nx, int(reverse), n, R,
                 ptrs(v[0] for v in ins), strides(ins),
                 ptrs(v[0] for v in dsts), strides(dsts), ptrs(parts),
                 block_size, stream, info)
    if err:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{err} (nx={nx}, n={n}, R={R}, "
                           f"block_size={block_size})")
    return outs, info


def _on_cuda(device: torch.device, name: str) -> None:
    if device.type != "cuda":
        raise ValueError(f"{name} kernel runs on CUDA tensors, got {device}")


def _scan_entry():
    build()
    return _lib.lqt_scan_launch


def _wide_entry():
    build_wide()
    return _wide_lib.lqt_scan_wide_launch


def lqt_scan(elems: LQTElement, *, reverse: bool = False,
             block_size: int = 128) -> LQTElement:
    """Inclusive scan of ``elems`` along axis 0, earlier operand first, in
    one kernel launch; ``reverse`` gives the suffix scan
    ``out[i] = a_i (x) ... (x) a_{n-1}``.

    ``elems``: ``(n, *R, nx, nx)`` / ``(n, *R, nx)`` of one dtype and
    device, ``1 <= nx <= MAX_NX``; records ``*R`` ride along in the same
    launch.  CUDA tensors run the kernel with ``block_size`` threads per
    block on the current stream and return new tensors in the natural
    layout; CPU tensors run the plain version.
    """
    device = elems[0].device
    if device.type == "cpu":
        return lqt_scan_ref(elems, reverse=reverse)
    _on_cuda(device, "lqt_scan")
    outs, info = _launch(elems, _check(elems), reverse, block_size,
                         "lqt_scan", _scan_entry)
    if info is not None:
        global _launches, last_launch
        _launches += 1
        last_launch = {"grid": info[0], "blocks_per_sm": info[1],
                       "smem_bytes": info[2]}
        obs.inc("scan.kernel.regs")
    return outs


def lqt_scan_wide(elems: LQTElement, *, reverse: bool = False
                  ) -> LQTElement:
    """The scan of :func:`lqt_scan` for wide states, ``9 <= nx <=
    NX_WIDE`` (checked on every device), by the wide kernel: one block of
    ``WIDE_THREADS`` threads per combine, :func:`wide_launches` launches a
    scan.  CPU tensors run the plain version."""
    shape = _check(elems, MAX_NX + 1, NX_WIDE, "lqt_scan_wide")
    device = elems[0].device
    if device.type == "cpu":
        return lqt_scan_ref(elems, reverse=reverse)
    _on_cuda(device, "lqt_scan_wide")
    outs, info = _launch(elems, shape, reverse, WIDE_THREADS,
                         "lqt_scan_wide", _wide_entry)
    if info is not None:
        global _wide_launches
        _wide_launches += info[0]
        obs.inc("scan.kernel.wide", info[0])
    return outs


def lqt_combine_wide(e1: LQTElement, e2: LQTElement) -> LQTElement:
    """Eq. (42) on pairs, ``out = e1 (x) e2`` elementwise over the leading
    ``(n, *R)`` dims that both share, ``9 <= nx <= NX_WIDE``: one launch
    of the wide kernel's pairwise entry, one block of ``WIDE_THREADS`` a
    pair, reading the operands in place (views whose record dims merge
    into one stride, broadcast ones included).  CPU tensors run the core
    combine."""
    n, rec, nx = _check(e1, MAX_NX + 1, NX_WIDE, "lqt_combine_wide")
    if _check(e2, MAX_NX + 1, NX_WIDE, "lqt_combine_wide") != (n, rec, nx):
        raise ValueError(f"operands of lqt_combine_wide differ in shape: "
                         f"{tuple(e1.A.shape)} and {tuple(e2.A.shape)}")
    device = e1.A.device
    if device.type == "cpu":
        return _core_combine(e1, e2)
    _on_cuda(device, "lqt_combine_wide")
    if e2.A.device != device or e2.A.dtype != e1.A.dtype:
        raise ValueError("operands of lqt_combine_wide must share a device "
                         "and a dtype")
    R = math.prod(rec)
    outs = LQTElement(*(torch.empty_like(x, memory_format=torch.contiguous_format)
                        for x in e1))
    if n == 0 or R == 0:
        return outs
    build_wide()
    views = [[_natural(x, n, R, m) for x, m in zip(e, _MAT)]
             for e in (e1, e2, outs)]

    def ptrs(vs):
        return (ctypes.c_void_p * 5)(*(v[0].data_ptr() for v in vs))

    def strides(vs):
        return (ctypes.c_int64 * 10)(*(v[1] for v in vs), *(v[2] for v in vs))

    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _wide_lib.lqt_combine_wide_launch(
            _DTYPE_CODES[e1.A.dtype], nx, n, R,
            *(f(vs) for vs in views for f in (ptrs, strides)),
            WIDE_THREADS, stream)
    if err:
        raise RuntimeError(f"lqt_combine_wide kernel launch failed with CUDA "
                           f"error {err} (nx={nx}, n={n}, R={R})")
    global _pair_launches
    _pair_launches += 1
    return outs
