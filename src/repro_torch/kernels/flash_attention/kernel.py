"""CUDA flash-attention kernel: build, binding and wrapper.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``repro/kernels/flash_attention/kernel.py::flash_attention``; the source's
header says what bounds it on an H100 and what the design does about that.
It is built at first use by ``nvcc`` into ``build/repro_torch/`` and
loaded with ``ctypes`` (``kernels/_build.py``); nothing is built while this
module is imported.

The wrapper :func:`flash_attention` runs the plain version
(:func:`.ref.mha_ref`) only for tensors on the CPU.  For CUDA tensors it
launches the kernel or raises; it never falls back.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from .._build import bf16_or_f32, compile_library, parse_ptxas
from .ref import mha_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (8, 16, 32, 64, 128)
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
        log, r"flash_attn_kernelILi(\d+)E(f|13__nv_bfloat16)E",
        lambda m: {"D": int(m.group(1)), "dtype": bf16_or_f32(m.group(2))})
    return sorted(rows, key=lambda r: (r["dtype"], r["D"]))


def build() -> dict:
    """Compile (if needed) and load the kernel library.

    Returns ``{"library", "seconds", "cached", "ptxas"}`` (build time, 0
    when already built, and registers/spills per instantiation).
    """
    global _lib, _build_info
    if _build_info is not None:
        return _build_info
    lib, info = compile_library("flash_attention", SOURCE)
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _lib = lib
    _build_info = {"library": info["library"], "seconds": info["seconds"],
                   "cached": info["cached"],
                   "ptxas": _parse_ptxas(info["log"])}
    return _build_info


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
    CUDA tensors run the kernel on the current stream; CPU tensors run the
    plain version.
    """
    if q.device.type == "cpu":
        return mha_ref(q, k, v, causal=causal, window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel runs on CUDA tensors, got "
                         f"{q.device}")
    _check(q, k, v)
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    if scale is None:
        scale = D ** -0.5
    o = torch.empty_like(q)
    if o.numel() == 0:            # a grid of zero blocks is a launch error
        return o
    build()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _lib.flash_attention_launch(
            _DTYPE_CODES[q.dtype], D, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), B, Hq, Hkv, Lq, Lk, int(causal),
            -1 if window is None else int(window), float(scale), stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed with CUDA "
                           f"error {err} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {q.dtype})")
    global _launches
    _launches += 1
    return o
