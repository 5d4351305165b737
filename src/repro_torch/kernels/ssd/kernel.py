"""CUDA chunked-SSD kernels: build, binding, dispatch and wrapper.

Two kernels replace the Pallas TPU kernel
``repro/kernels/ssd/kernel.py::ssd_chunked``; each source's header says
what bounds it on an H100 and what its design does about that:

* ``csrc/ssd_mma.cu`` (variant ``"mma"``): chunk-parallel, three launches
  (chunk elements, a scan over chunks, chunk outputs), products on the bf16
  tensor cores (``mma.sync``) with float32 operands split into bf16 hi/lo
  pairs;
* ``csrc/ssd.cu`` (variant ``"simt"``): one block per sequence walking its
  chunks, float32 products on the CUDA cores.

The dispatch rule (:func:`variant`, a plain function of dtype and P): a
bfloat16 call with P a multiple of 8 (every P in :data:`HEAD_DIMS`) runs
``"mma"``; S < 16, P < 16 and chunks that are not multiples of 16 are
padded with zeros in its shared memory.  float32 storage, and any P that is
not a multiple of 8, run ``"simt"``.  Each library is built at first use by
``nvcc`` into ``build/repro_torch/`` and loaded with ``ctypes``
(``kernels/_build.py``); nothing is built while this module is imported.

The wrapper :func:`ssd_chunked` runs the plain version
(:func:`.ref.ssd_chunked_ref`) only for tensors on the CPU.  For CUDA
tensors it launches the variant the rule names or raises; it never falls
back.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from .._build import bf16_or_f32, compile_library, parse_ptxas
from .ref import ssd_chunked_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd.cu"
SOURCE_MMA = Path(__file__).resolve().parent / "csrc" / "ssd_mma.cu"
SOURCES = {"mma": SOURCE_MMA, "simt": SOURCE}
VARIANTS = tuple(SOURCES)
STAGES = ("chunk_state", "state_pass", "chunk_scan")
HEAD_DIMS = (8, 16, 32, 64, 128)
MAX_STATE = 128
MAX_CHUNK = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lib: Optional[ctypes.CDLL] = None        # the "simt" library
_lib_mma: Optional[ctypes.CDLL] = None
_build_info: dict = {}
_launches = dict.fromkeys(VARIANTS, 0)


def variant(dtype: torch.dtype, P: int) -> str:
    """The kernel a CUDA call runs: ``"mma"`` for bfloat16 with P a
    multiple of 8, ``"simt"`` otherwise (float32 storage)."""
    return "mma" if dtype == torch.bfloat16 and P % 8 == 0 else "simt"


def launch_count(variant: Optional[str] = None) -> int:
    """Calls that launched one variant (or either, summed) since the last
    :func:`reset_launch_count`; a call of ``"mma"`` is one count for its
    three launches."""
    return sum(_launches.values()) if variant is None else _launches[variant]


def reset_launch_count() -> None:
    for v in _launches:
        _launches[v] = 0


def _parse_ptxas(log: str) -> list:
    rows = parse_ptxas(
        log, r"ssd_chunk_kernelILi(\d+)E(f|13__nv_bfloat16)E",
        lambda m: {"P": int(m.group(1)), "dtype": bf16_or_f32(m.group(2))})
    rows += parse_ptxas(
        log, r"(ssd_chunk_state|ssd_state_pass|ssd_chunk_scan)_kernel"
             r"(?:ILi(\d+)E)?",
        lambda m: {"stage": m.group(1)[4:],
                   **({"PB": int(m.group(2))} if m.group(2) else {}),
                   "dtype": "bfloat16"})
    return sorted(rows, key=lambda r: (r["dtype"], r.get("stage", ""),
                                       r.get("P", r.get("PB", 0))))


def build(variant: str) -> dict:
    """Compile (if needed) and load one variant's library.

    Returns ``{"library", "seconds", "cached", "ptxas"}`` (build time, 0
    when already built, and registers/spills per kernel instantiation).
    """
    global _lib, _lib_mma
    if variant in _build_info:
        return _build_info[variant]
    lib, info = compile_library(f"ssd_{variant}", SOURCES[variant])
    vp, i = ctypes.c_void_p, ctypes.c_int
    if variant == "mma":
        lib.ssd_chunk_state_launch.argtypes = [vp] * 5 + [i] * 5 + [vp]
        lib.ssd_state_pass_launch.argtypes = [vp] * 2 + [i] * 4 + [vp]
        lib.ssd_chunk_scan_launch.argtypes = [vp] * 6 + [i] * 5 + [vp]
        for stage in STAGES:
            getattr(lib, f"ssd_{stage}_launch").restype = i
        _lib_mma = lib
    else:
        lib.ssd_chunked_launch.argtypes = [i, i] + [vp] * 5 + [i] * 4 + [vp]
        lib.ssd_chunked_launch.restype = i
        _lib = lib
    _build_info[variant] = {
        "library": info["library"], "seconds": info["seconds"],
        "cached": info["cached"], "ptxas": _parse_ptxas(info["log"])}
    return _build_info[variant]


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
      y: (BH, L, P) in dtx's dtype.  CUDA tensors run the kernel
      :func:`variant` names on the current stream; CPU tensors run the
      plain version.
    """
    if dtx.device.type == "cpu":
        if dtx.shape[1] % chunk:
            raise ValueError(f"L={dtx.shape[1]} must be a multiple of "
                             f"chunk={chunk}")
        return ssd_chunked_ref(l, dtx, B, C, chunk=chunk)
    if variant(dtx.dtype, dtx.shape[-1]) == "mma":
        return _run_mma(l, dtx, B, C, chunk)[0]
    return _run_simt(l, dtx, B, C, chunk)


def _check_cuda(l, dtx, B, C, chunk: int) -> None:
    if dtx.device.type != "cuda":
        raise ValueError(f"ssd kernel runs on CUDA tensors, got "
                         f"{dtx.device}")
    _check(l, dtx, B, C, chunk)


def _run_simt(l, dtx, B, C, chunk: int):
    """The simt kernel on CUDA tensors (float32 storage by the rule; a
    caller may name it for bfloat16 as a same-card comparison)."""
    _check_cuda(l, dtx, B, C, chunk)
    BH, L, P = dtx.shape
    y = torch.empty_like(dtx)
    if y.numel() == 0:            # a grid of zero blocks is a launch error
        return y
    build("simt")
    stream = torch.cuda.current_stream(dtx.device).cuda_stream
    with torch.cuda.device(dtx.device):
        err = _lib.ssd_chunked_launch(
            _DTYPE_CODES[dtx.dtype], P, l.data_ptr(), dtx.data_ptr(),
            B.data_ptr(), C.data_ptr(), y.data_ptr(), BH, L, B.shape[-1],
            chunk, stream)
    if err:
        raise RuntimeError(f"ssd simt kernel launch failed with CUDA error "
                           f"{err} (dtx {tuple(dtx.shape)}, S={B.shape[-1]}, "
                           f"chunk={chunk}, {dtx.dtype})")
    _launches["simt"] += 1
    return y


def _mma_stages(l, dtx, B, C, chunk: int):
    """``(y, states, totals, args)``: the outputs and scratch of the "mma"
    kernel, and each stage's C arguments (all but the stream)."""
    _check_cuda(l, dtx, B, C, chunk)
    BH, L, P = dtx.shape
    S = B.shape[-1]
    if dtx.dtype != torch.bfloat16 or P % 8:
        raise ValueError(f"the mma kernel takes bfloat16 with P a multiple "
                         f"of 8, got {dtx.dtype}, P={P}")
    for name, x in (("l", l), ("dtx", dtx), ("B", B), ("C", C)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the mma "
                             f"kernel's vector copies")
    nc = L // chunk
    y = torch.empty_like(dtx)
    states = torch.empty((BH, nc, P, S), dtype=torch.float32,
                         device=dtx.device)
    totals = torch.empty((BH, nc), dtype=torch.float32, device=dtx.device)
    build("mma")
    pl, px, pB, pC, ps, pt, py = (t.data_ptr() for t in
                                  (l, dtx, B, C, states, totals, y))
    args = {"chunk_state": (pl, px, pB, ps, pt, BH, L, P, S, chunk),
            "state_pass": (pt, ps, BH, nc, P, S),
            "chunk_scan": (pl, px, pB, pC, ps, py, BH, L, P, S, chunk)}
    return y, states, totals, args


def _launch_stage(stage: str, args: tuple, stream: int) -> None:
    """One stage of the "mma" kernel; raises on a launch error."""
    err = getattr(_lib_mma, f"ssd_{stage}_launch")(*args, stream)
    if err:
        raise RuntimeError(f"ssd mma stage {stage} launch failed with CUDA "
                           f"error {err} (arguments {args})")


def _run_mma(l, dtx, B, C, chunk: int):
    """The three stages on CUDA tensors, on the current stream:
    ``(y, states, totals)``, with ``states[:, c]`` the state entering
    chunk ``c``."""
    y, states, totals, args = _mma_stages(l, dtx, B, C, chunk)
    if y.numel():
        stream = torch.cuda.current_stream(dtx.device).cuda_stream
        with torch.cuda.device(dtx.device):
            for stage in STAGES:
                _launch_stage(stage, args[stage], stream)
        _launches["mma"] += 1
    return y, states, totals
