"""Drivers of the LQT-combine kernel.

``lqt_combine_batched`` takes the natural ``(B, nx, nx)``/``(B, nx)``
layout, re-lays it out lane-major (batch last), runs the kernel and
restores the layout.  When the whole scan runs kernel-side the lane-major
layout is kept across levels instead -- ``kernel_prefix_scan`` /
``kernel_suffix_scan`` do ONE ``_to_lanes``/``_from_lanes`` round-trip in
all, and every tree level slices and combines lane-major operands.  The
tree is :func:`repro_torch.core.pscan.associative_scan`, so the combine
ORDER matches the plain scan; the per-combine arithmetic still differs
(unpivoted Gauss-Jordan vs pivoted ``torch.linalg.solve``), so on the card
results agree to a tolerance, not bit-exactly.

Record batches: elements ``(n, *R, nx, nx)`` go lane-major as
``(nx, nx, *R, n)``: the scan axis is the LAST axis, as in the reference,
and one kernel launch per tree level covers every record.  The tree
level's strided lane slices are made contiguous on purpose before each
launch (the kernel takes dense operands); the copies are the price of a
kernel without stride arguments.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.core.pscan import associative_scan
from repro_torch.core.types import LQTElement

from .kernel import _MAT, lqt_combine_lanes

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


def _scan_lanes(ops, combine):
    """Inclusive prefix scan over the LANE (last) axis, earlier operand
    first: the pair-reduce/odd-scan/even-fixup tree of the plain scan, so
    each level is one (or two) kernel combines over lane slices."""
    return associative_scan(combine, ops, axis=-1)


def _scan_dtype(precision: str, dtype: torch.dtype) -> torch.dtype:
    if precision in (None, "default"):
        return dtype
    try:
        return _PRECISIONS[precision]
    except KeyError:
        raise ValueError(f"precision must be 'default', 'float32' or "
                         f"'float64', got {precision!r}") from None


def kernel_prefix_scan(elems: LQTElement, *, block_size: int = 128,
                       precision: str = "default") -> LQTElement:
    """Inclusive prefix combine along axis 0 (earlier operand first), run
    kernel-side in lane-major layout with one layout round-trip in all.

    ``precision`` selects the kernel compute dtype (``"default"`` keeps the
    element dtype; ``"float32"``/``"float64"`` cast for the scan and cast
    the result back).
    """
    lanes = _to_lanes(elems)
    in_dtype = lanes[0].dtype
    cdtype = _scan_dtype(precision, in_dtype)
    combine = functools.partial(_combine_lanes, block_size=block_size)
    out = _scan_lanes(tuple(a.to(cdtype) for a in lanes), combine)
    return _from_lanes(tuple(a.to(in_dtype) for a in out))


def kernel_suffix_scan(elems: LQTElement, *, block_size: int = 128,
                       precision: str = "default") -> LQTElement:
    """Inclusive suffix combine along axis 0 (earlier operand first):
    ``out[i] = a_i (x) ... (x) a_{T-1}``, matching
    :func:`repro_torch.core.pscan.suffix_scan` -- a flip of the lane axis
    plus an operand swap, so non-commutativity is preserved."""
    lanes = _to_lanes(elems)
    in_dtype = lanes[0].dtype
    cdtype = _scan_dtype(precision, in_dtype)
    flipped = tuple(torch.flip(a.to(cdtype), (-1,)) for a in lanes)

    def swapped(a, b):
        return _combine_lanes(b, a, block_size=block_size)

    out = _scan_lanes(flipped, swapped)
    return _from_lanes(tuple(torch.flip(a, (-1,)).to(in_dtype) for a in out))
