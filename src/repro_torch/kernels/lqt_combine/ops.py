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
no flip, transpose or per-level copy around it.  States wider than
``MAX_NX`` take the wide kernel (``scan.lqt_scan_wide``: one launch per
tree level, the same tree), whose pairwise entry also does their in-block
work in ``discrete`` mode (:func:`in_block_steps`).  The tree is
:func:`repro_torch.core.pscan.associative_scan`'s, so the combine ORDER
matches the plain scan; the per-combine arithmetic still differs
(unpivoted Gauss-Jordan vs pivoted ``torch.linalg.solve``), so on the card
results agree to a tolerance, not bit-exactly.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.combine import value_as_element
from repro_torch.core.elements import CORE_STEPS, InBlockSteps
from repro_torch.core.types import LQTElement, ValueFn

from .kernel import _MAT, MAX_NX, lqt_combine_lanes
from .scan import lqt_combine_wide, lqt_scan, lqt_scan_wide

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
    """The scan by the kernel that takes the elements' width: the register
    kernel up to ``MAX_NX``, the wide kernel above it."""
    in_dtype = elems[0].dtype
    cdtype = _scan_dtype(precision, in_dtype)
    elems = LQTElement(*(a.to(cdtype) for a in elems))
    if elems.A.shape[-1] <= MAX_NX:
        out = lqt_scan(elems, reverse=reverse, block_size=block_size)
    else:
        out = lqt_scan_wide(elems, reverse=reverse)
    return LQTElement(*(a.to(in_dtype) for a in out))


def kernel_prefix_scan(elems: LQTElement, *, block_size: int = 128,
                       precision: str = "default") -> LQTElement:
    """Inclusive prefix combine along axis 0 (earlier operand first), one
    scan-kernel launch with ``block_size`` threads per block (states wider
    than ``MAX_NX``: the wide kernel, its own block of
    ``scan.WIDE_THREADS``).

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


def _wide_value_step(e: LQTElement, value: ValueFn) -> ValueFn:
    """A value taken back across ``e``: the (J, eta) of
    ``e (x) (0, 0, 0, v, S)``."""
    out = lqt_combine_wide(e, value_as_element(value))
    return ValueFn(out.J, out.eta)


def _wide_recovery_maps(A, b, C, S1, v1):
    """The argmin step's map ``(Phi, beta)``: the (A, b) of
    ``(A, b, C, 0, 0) (x) (I, 0, 0, v1, S1)``."""
    I = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    Z = torch.zeros_like(I).expand(S1.shape)
    z = torch.zeros_like(I[0]).expand(v1.shape)
    maps = lqt_combine_wide(LQTElement(A, b, C, z, Z),
                            LQTElement(I.expand(S1.shape), z, Z, v1, S1))
    return maps.A, maps.b


# the in-block work of states wider than MAX_NX, each step one launch of
# the wide kernel's pairwise entry: at nx = 40 the core's steps would run
# torch's batched LU (MAGMA's getrf, a row-swap launch per column)
WIDE_STEPS = InBlockSteps(lqt_combine_wide, _wide_value_step,
                          _wide_recovery_maps)


def in_block_steps(nx: int) -> InBlockSteps:
    """The in-block steps of ``discrete`` mode for states ``nx`` wide
    (``core.elements.InBlockSteps``): the core's own up to ``MAX_NX``,
    :data:`WIDE_STEPS` above it."""
    return CORE_STEPS if nx <= MAX_NX else WIDE_STEPS
