"""CUDA flash-attention kernels: build, binding, dispatch and wrapper.

Two kernels replace the Pallas TPU kernel
``repro/kernels/flash_attention/kernel.py::flash_attention``; each
source's header says what bounds it on an H100 and what its design does
about that:

* ``csrc/flash_attention_mma.cu`` (variant ``"mma"``): bf16 operands on the
  tensor cores (``mma.sync``), FlashAttention-2 style, D in
  :data:`MMA_HEAD_DIMS`;
* ``csrc/flash_attention.cu`` (variant ``"simt"``): float32 products on
  the CUDA cores, for float32 storage (its 2e-5 tolerance rules out TF32)
  and for bf16 with D = 8, below the tensor cores' depth of 16.

:func:`variant` is the dispatch rule, a plain function of dtype and D.
Each library is built at first use by ``nvcc`` into ``build/repro_torch/``
and loaded with ``ctypes`` (``kernels/_build.py``); nothing is built while
this module is imported.

The wrapper :func:`flash_attention` runs the plain version
(:func:`.ref.mha_ref`) only for tensors on the CPU.  For CUDA tensors it
launches the variant the rule names or raises; it never falls back.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from .._build import bf16_or_f32, compile_library, parse_ptxas
from .ref import mha_ref

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = _CSRC / "flash_attention.cu"
SOURCE_MMA = _CSRC / "flash_attention_mma.cu"
SOURCES = {"mma": SOURCE_MMA, "simt": SOURCE}
VARIANTS = tuple(SOURCES)
HEAD_DIMS = (8, 16, 32, 64, 80, 128)
MMA_HEAD_DIMS = (16, 32, 64, 80, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lib: Optional[ctypes.CDLL] = None        # the "simt" library
_lib_mma: Optional[ctypes.CDLL] = None
_build_info: dict = {}
_launches = dict.fromkeys(VARIANTS, 0)


def variant(dtype: torch.dtype, D: int) -> str:
    """The kernel a CUDA call runs: ``"mma"`` for bfloat16 with D in
    :data:`MMA_HEAD_DIMS` (D >= 16), ``"simt"`` for float32 and for
    bfloat16 with D = 8."""
    return "mma" if dtype == torch.bfloat16 and D in MMA_HEAD_DIMS else "simt"


def launch_count(variant: Optional[str] = None) -> int:
    """Kernel launches of one variant (or of both, summed) since the last
    :func:`reset_launch_count`."""
    return sum(_launches.values()) if variant is None else _launches[variant]


def reset_launch_count() -> None:
    for v in _launches:
        _launches[v] = 0


def _parse_ptxas(log: str) -> list:
    rows = parse_ptxas(
        log, r"flash_attn_kernelILi(\d+)E(f|13__nv_bfloat16)E",
        lambda m: {"D": int(m.group(1)), "dtype": bf16_or_f32(m.group(2))})
    rows += parse_ptxas(
        log, r"flash_attn_mma_kernelILi(\d+)E",
        lambda m: {"D": int(m.group(1)), "dtype": "bfloat16"})
    return sorted(rows, key=lambda r: (r["dtype"], r["D"]))


def build(variant: str) -> dict:
    """Compile (if needed) and load one variant's library.

    Returns ``{"library", "seconds", "cached", "ptxas"}`` (build time, 0
    when already built, and registers/spills per instantiation).
    """
    global _lib, _lib_mma
    if variant in _build_info:
        return _build_info[variant]
    lib, info = compile_library(f"flash_attention_{variant}",
                                SOURCES[variant])
    # (dtype,) D, q, k, v, o, B, Hq, Hkv, Lq, Lk, causal, window, scale,
    # stream
    args = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_void_p])
    if variant == "mma":
        fn = lib.flash_attention_mma_launch
        fn.argtypes = args
        _lib_mma = lib
    else:
        fn = lib.flash_attention_launch
        fn.argtypes = [ctypes.c_int] + args
        _lib = lib
    fn.restype = ctypes.c_int
    _build_info[variant] = {
        "library": info["library"], "seconds": info["seconds"],
        "cached": info["cached"], "ptxas": _parse_ptxas(info["log"])}
    return _build_info[variant]


def _check(q, k, v) -> None:
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, L, D)")
    B, Hq, Lq, D = q.shape
    Bk, Hkv, Lk, Dk = k.shape
    if tuple(v.shape) != tuple(k.shape) or Bk != B or Dk != D:
        raise ValueError(f"k and v must be (B, Hkv, Lk, D) = "
                         f"({B}, Hkv, Lk, {D}), got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes D in {HEAD_DIMS}, "
                         f"got {D}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    if Lq > Lk:
        raise ValueError(f"Lq={Lq} > Lk={Lk}: q rows align to the end of "
                         f"the keys")
    for name, x in (("k", k), ("v", v)):
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} is {x.dtype} on {x.device}; q is "
                             f"{q.dtype} on {q.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None):
    """Flash attention with GQA head folding.

    q: (B, Hq, Lq, D); k, v: (B, Hkv, Lk, D), Lq <= Lk (the q rows are
    aligned to the END of the keys).  Returns (B, Hq, Lq, D) in q's dtype.
    CUDA tensors run the kernel :func:`variant` names on the current
    stream; CPU tensors run the plain version.
    """
    if q.device.type == "cpu":
        return mha_ref(q, k, v, causal=causal, window=window, scale=scale)
    return _run(variant(q.dtype, q.shape[-1]), q, k, v, causal=causal,
                window=window, scale=scale)


def _run(which: str, q, k, v, *, causal: bool = True,
         window: Optional[int] = None, scale: Optional[float] = None):
    """Launch one variant on CUDA tensors.  :func:`flash_attention` picks
    the variant; a caller that names one itself (a same-card comparison of
    the two designs) bypasses the rule."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel runs on CUDA tensors, got "
                         f"{q.device}")
    _check(q, k, v)
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    if which == "mma":
        if q.dtype != torch.bfloat16 or D not in MMA_HEAD_DIMS:
            raise ValueError(f"the mma kernel takes bfloat16 with D in "
                             f"{MMA_HEAD_DIMS}, got {q.dtype}, D={D}")
        for name, x in (("q", q), ("k", k), ("v", v)):
            if x.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned for the "
                                 f"mma kernel's cp.async copies")
    if scale is None:
        scale = D ** -0.5
    o = torch.empty_like(q)
    if o.numel() == 0:            # a grid of zero blocks is a launch error
        return o
    build(which)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Hq,
            Hkv, Lq, Lk, int(causal), -1 if window is None else int(window),
            float(scale), stream)
    with torch.cuda.device(q.device):
        if which == "mma":
            err = _lib_mma.flash_attention_mma_launch(D, *args)
        else:
            err = _lib.flash_attention_launch(_DTYPE_CODES[q.dtype], D, *args)
    if err:
        raise RuntimeError(f"flash_attention {which} kernel launch failed "
                           f"with CUDA error {err} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {q.dtype})")
    _launches[which] += 1
    return o
