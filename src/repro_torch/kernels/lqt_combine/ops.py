"""Drivers of the LQT-combine kernels.

``lqt_combine_batched`` takes the natural ``(B, nx, nx)``/``(B, nx)``
layout, re-lays it out lane-major (batch last), runs the pairwise kernel
(``kernel.py``) and restores the layout.  ``scan_combine_fn`` wraps it as
the combine of :mod:`repro_torch.core.pscan`'s scans (``parallel_rts(...,
combine_fn=...)``, ``parallel_two_filter``, ``sharded_scan``): one launch
per tree level, and one per carry combine and fix-up of a sharded scan.

``kernel_prefix_scan`` / ``kernel_suffix_scan`` run a whole scan in ONE
launch of the scan kernel (``scan.py``), every tree level and every record
of ``(n, *R, nx, nx)`` elements, read and written in their natural layout:
no flip, transpose or per-level copy around it.  The tree is
:func:`repro_torch.core.pscan.associative_scan`'s, so the combine ORDER
matches the plain scan; the per-combine arithmetic still differs
(unpivoted Gauss-Jordan vs pivoted ``torch.linalg.solve``), so on the card
results agree to a tolerance, not bit-exactly.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.types import LQTElement

from .kernel import _MAT, lqt_combine_lanes
from .scan import lqt_scan

_PRECISIONS = {"float32": torch.float32, "float64": torch.float64}


def _to_lanes(e: LQTElement):
    """``(n, *R, nx, nx)`` / ``(n, *R, nx)`` -> ``(nx, nx, *R, n)`` /
    ``(nx, *R, n)`` views."""
    return tuple(
        a.movedim(0, -1).movedim((-3, -2), (0, 1)) if mat
        else a.movedim(0, -1).movedim(-2, 0)
        for a, mat in zip(e, _MAT))


def _from_lanes(ops) -> LQTElement:
    return LQTElement(*(
        a.movedim(-1, 0).movedim((1, 2), (-2, -1)) if mat
        else a.movedim(-1, 0).movedim(1, -1)
        for a, mat in zip(ops, _MAT)))


def _combine_lanes(ops1, ops2, *, block_size: int):
    """Kernel combine on lane-major 5-tuples with ANY lane dims: the lane
    dims are made dense and flattened to the kernel's one lane axis.
    ``B == 0`` (empty tree levels) short-circuits."""
    lanes = tuple(ops1[0].shape[2:])
    B = math.prod(lanes)
    if B == 0:
        return ops1

    def flat(ops):
        return tuple(a.contiguous().reshape(a.shape[:2 if mat else 1] + (B,))
                     for a, mat in zip(ops, _MAT))

    out = lqt_combine_lanes(flat(ops1), flat(ops2), block_size=block_size)
    return tuple(a.reshape(a.shape[:-1] + lanes) for a in out)


def lqt_combine_batched(e1: LQTElement, e2: LQTElement, *,
                        block_size: int = 128) -> LQTElement:
    """Kernel-backed eq. (42) combine on natural-layout elements
    ``(B, ..., nx, nx)``."""
    if e1.A.shape[0] == 0:
        return e1
    return _from_lanes(_combine_lanes(_to_lanes(e1), _to_lanes(e2),
                                      block_size=block_size))


def _scan_dtype(precision: str, dtype: torch.dtype) -> torch.dtype:
    if precision in (None, "default"):
        return dtype
    try:
        return _PRECISIONS[precision]
    except KeyError:
        raise ValueError(f"precision must be 'default', 'float32' or "
                         f"'float64', got {precision!r}") from None


def _scan(elems: LQTElement, reverse: bool, block_size: int,
          precision: str) -> LQTElement:
    in_dtype = elems[0].dtype
    cdtype = _scan_dtype(precision, in_dtype)
    out = lqt_scan(LQTElement(*(a.to(cdtype) for a in elems)),
                   reverse=reverse, block_size=block_size)
    return LQTElement(*(a.to(in_dtype) for a in out))


def kernel_prefix_scan(elems: LQTElement, *, block_size: int = 128,
                       precision: str = "default") -> LQTElement:
    """Inclusive prefix combine along axis 0 (earlier operand first), one
    scan-kernel launch with ``block_size`` threads per block.

    ``precision`` selects the kernel compute dtype (``"default"`` keeps the
    element dtype; ``"float32"``/``"float64"`` cast for the scan and cast
    the result back).
    """
    return _scan(elems, False, block_size, precision)


def kernel_suffix_scan(elems: LQTElement, *, block_size: int = 128,
                       precision: str = "default") -> LQTElement:
    """Inclusive suffix combine along axis 0 (earlier operand first):
    ``out[i] = a_i (x) ... (x) a_{T-1}``, matching
    :func:`repro_torch.core.pscan.suffix_scan` -- the reversed scan with
    the operands swapped, done by the kernel's index arithmetic, so
    non-commutativity is preserved."""
    return _scan(elems, True, block_size, precision)


def scan_combine_fn(*, block_size: int = 128):
    """Combine callable for :mod:`repro_torch.core.pscan` scans, backed by
    the pairwise kernel (:func:`lqt_combine_batched`; on CPU tensors its
    plain version), and broadcast-compatible: an operand of lower rank (a
    carried single element ``(nx, nx)``) is expanded to the other's
    shape, and two single elements combine as a batch of one."""

    def fn(a: LQTElement, b: LQTElement) -> LQTElement:
        if a.A.dim() < b.A.dim():
            a = LQTElement(*(x.expand(y.shape) for x, y in zip(a, b)))
        elif b.A.dim() < a.A.dim():
            b = LQTElement(*(y.expand(x.shape) for x, y in zip(a, b)))
        if a.A.dim() == 2:
            out = lqt_combine_batched(LQTElement(*(x[None] for x in a)),
                                      LQTElement(*(x[None] for x in b)),
                                      block_size=block_size)
            return LQTElement(*(x[0] for x in out))
        return lqt_combine_batched(a, b, block_size=block_size)

    return fn
