"""Parallel associative scans over tuples of tensors.

Orientation conventions (critical for the non-commutative operators of
``combine.py``):

* ``prefix_scan(fn, a)[i] = a_0 (x) a_1 (x) ... (x) a_i``  (eq. 25)
* ``suffix_scan(fn, a)[i] = a_i (x) a_{i+1} (x) ... (x) a_{T-1}``  (eq. 26)

where ``fn(x, y)`` always receives ``x`` as the EARLIER-interval operand.

PyTorch has no ``associative_scan``, so :func:`associative_scan` writes out
the recursion of ``jax.lax.associative_scan`` (pair-reduce, odd-scan,
even-fixup).  Using the same tree keeps the combine ORDER identical to the
reference package, so float64 results agree to round-off.  The scan kernel
(``repro_torch.kernels.lqt_combine.scan``) runs the same tree, combine for
combine, in one launch.
"""
from __future__ import annotations

from typing import Callable, Sequence, TypeVar

import torch

T = TypeVar("T", bound=Sequence[torch.Tensor])


def _remake(like, values):
    """Rebuild a tuple or NamedTuple of the same type as ``like`` (not via
    ``_make``: the element types override ``__len__`` with the scan
    length, which ``_make``'s field-count check would read)."""
    return type(like)(*values) if hasattr(like, "_fields") else tuple(values)


def _index(axis: int, sl: slice):
    if axis == 0:
        return (sl,)
    if axis == -1:
        return (Ellipsis, sl)
    raise ValueError(f"axis must be 0 or -1, got {axis}")


def _slice(elems: T, axis: int, start, stop=None, step=None) -> T:
    idx = _index(axis, slice(start, stop, step))
    return _remake(elems, [x[idx] for x in elems])


def _interleave(even: torch.Tensor, odd: torch.Tensor, axis: int):
    """Riffle along ``axis``: out[0::2] = even, out[1::2] = odd."""
    shape = list(even.shape)
    shape[axis] = even.shape[axis] + odd.shape[axis]
    out = even.new_empty(shape)
    out[_index(axis, slice(0, None, 2))] = even
    out[_index(axis, slice(1, None, 2))] = odd
    return out


def associative_scan(fn: Callable[[T, T], T], elems: T, axis: int = 0) -> T:
    """Inclusive prefix combine along ``axis`` (0 or -1) of every tensor
    in ``elems``, earlier operand first -- the recursive tree of
    ``jax.lax.associative_scan``.  Combines over empty tree levels (which
    the recursion produces, e.g. at length 2) are skipped."""
    n = elems[0].shape[axis]
    if n < 2:
        return elems
    reduced = fn(_slice(elems, axis, 0, -1, 2), _slice(elems, axis, 1, None, 2))
    odd = associative_scan(fn, reduced, axis)
    left = odd if n % 2 else _slice(odd, axis, 0, -1)
    even_in = _slice(elems, axis, 2, None, 2)
    even = fn(left, even_in) if even_in[0].shape[axis] else even_in
    head = _slice(elems, axis, 0, 1)
    return _remake(elems, [
        _interleave(torch.cat([h, e], dim=axis), o, axis)
        for h, e, o in zip(head, even, odd)])


def prefix_scan(fn: Callable[[T, T], T], elems: T, *,
                sequential: bool = False) -> T:
    """Inclusive prefix combine along axis 0 (earlier operand first)."""
    if sequential:
        return _sequential_prefix(fn, elems)
    return associative_scan(fn, elems)


def suffix_scan(fn: Callable[[T, T], T], elems: T, *,
                sequential: bool = False) -> T:
    """Inclusive suffix combine along axis 0 (earlier operand first).

    Flip plus an operand swap: a flipped prefix scan alone would silently
    transpose the non-commutative combine."""
    if sequential:
        return _sequential_suffix(fn, elems)
    flipped = _remake(elems, [torch.flip(x, (0,)) for x in elems])
    out = associative_scan(lambda a, b: fn(b, a), flipped)
    return _remake(elems, [torch.flip(x, (0,)) for x in out])


def _stack(like, items):
    return _remake(like, [torch.stack(xs, dim=0) for xs in zip(*items)])


def _sequential_prefix(fn, elems):
    """O(T)-span reference fold (the paper's sequential baseline shape)."""
    carry = _remake(elems, [x[0] for x in elems])
    out = [carry]
    for i in range(1, elems[0].shape[0]):
        carry = fn(carry, _remake(elems, [x[i] for x in elems]))
        out.append(carry)
    return _stack(elems, out)


def _sequential_suffix(fn, elems):
    n = elems[0].shape[0]
    carry = _remake(elems, [x[n - 1] for x in elems])
    out = [carry]
    for i in range(n - 2, -1, -1):
        carry = fn(_remake(elems, [x[i] for x in elems]), carry)
        out.append(carry)
    return _stack(elems, out[::-1])
