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

:func:`distributed_scan` is the per-shard algorithm of a time axis split
over P devices: local scan on each shard's device -> the P per-shard
carries gathered to the home device -> a sequential scan over them ->
each shard's carry sent back for a local fix-up.  Work O(T/P + P) per
device, span O(log(T/P) + P).  :func:`sharded_scan` is the top-level entry
around it (``method="distributed"``): it splits the scan over a mesh
axis, handles lengths that P does not divide, and degrades to the plain
scan when there is nothing to shard.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, TypeVar

import torch

from repro_torch import obs
from repro_torch.distributed.sharding import device_scope
from repro_torch.obs.metrics import inc_per_entry

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


def _at(elems: T, i: int) -> T:
    """Element ``i`` of the scan axis (rank-reduced)."""
    return _remake(elems, [x[i] for x in elems])


def _sequential_prefix(fn, elems):
    """O(T)-span reference fold (the paper's sequential baseline shape)."""
    carry = _at(elems, 0)
    out = [carry]
    for i in range(1, elems[0].shape[0]):
        carry = fn(carry, _at(elems, i))
        out.append(carry)
    return _stack(elems, out)


def _sequential_suffix(fn, elems):
    n = elems[0].shape[0]
    carry = _at(elems, n - 1)
    out = [carry]
    for i in range(n - 2, -1, -1):
        carry = fn(_at(elems, i), carry)
        out.append(carry)
    return _stack(elems, out[::-1])


def _bcast(carry: T, like: T) -> T:
    """A rank-reduced ``carry`` expanded (a view, no copy) over the scan
    axis of ``like``, so that the combine meets equal shapes."""
    return _remake(like, [c.expand(x.shape) for c, x in zip(carry, like)])


def _cast(elems: T, dtypes, device=None) -> T:
    return _remake(elems, [x.to(device=device, dtype=d)
                           for x, d in zip(elems, dtypes)])


def distributed_scan(
    fn: Callable[[T, T], T],
    shards: Sequence[T],
    *,
    reverse: bool = False,
    carry_dtype: Optional[torch.dtype] = None,
    home: Optional[torch.device] = None,
) -> List[T]:
    """Associative scan over a time axis split into ``shards``.

    ``shards[i]`` holds the ``i``-th consecutive piece of the time axis
    (axis 0) on the device that runs it.  Returns each shard's piece of
    the global inclusive prefix (suffix if ``reverse``), on that shard's
    device.  The per-shard carries meet on ``home`` (default: the first
    shard's device), where the one O(P)-sequential scan over them runs --
    in ``carry_dtype`` if given (e.g. float64 for float32 elements: the
    carry chain accumulates the most round-off), cast back to the element
    dtypes before the fix-up.

    No identity element is needed: the edge shard (the last one of a
    suffix scan, shard 0 of a prefix scan) keeps its local result.  The
    combine keeps the earlier operand first throughout.
    """
    local = []
    for s in shards:
        with device_scope(s[0].device):
            local.append(suffix_scan(fn, s) if reverse
                         else prefix_scan(fn, s))
    home = shards[0][0].device if home is None else home
    dtypes = [x.dtype for x in local[0]]
    carries = [_at(l, 0 if reverse else -1) for l in local]
    totals = _remake(local[0], [torch.stack([x.to(home) for x in xs])
                                for xs in zip(*carries)])
    if carry_dtype is not None:
        totals = _cast(totals, [carry_dtype] * len(dtypes))
    p = len(shards)
    out = []
    if reverse:
        # the inclusive suffix of the totals strictly AFTER each shard
        suff = suffix_scan(fn, totals, sequential=True)
        for i, l in enumerate(local):
            if i == p - 1:
                out.append(l)
                continue
            dev = l[0].device
            with device_scope(dev):
                nxt = _cast(_at(suff, i + 1), dtypes, dev)
                out.append(fn(l, _bcast(nxt, l)))
        return out
    pref = prefix_scan(fn, totals, sequential=True)
    for i, l in enumerate(local):
        if i == 0:
            out.append(l)
            continue
        dev = l[0].device
        with device_scope(dev):
            prev = _cast(_at(pref, i - 1), dtypes, dev)
            out.append(fn(_bcast(prev, l), l))
    return out


def sharded_scan(
    fn: Callable[[T, T], T],
    elems: T,
    *,
    mesh,
    axis_name: str,
    reverse: bool = False,
    carry_dtype: Optional[torch.dtype] = None,
) -> T:
    """Time-axis-sharded associative scan of any length T over the devices
    along ``mesh``'s ``axis_name`` axis; the result lands on ``elems``'
    device.

    A length that the shard count P does not divide is split: the largest
    P-divisible head runs distributed, the tail (< P elements) runs
    locally and is folded in with one broadcast combine.  Degrades to the
    plain scan when P < 2 or T < 2P (shards shorter than the carry
    chain).

    With :mod:`repro_torch.obs` enabled, every sharded scan counts
    ``distributed.shards`` (time shards used) and
    ``distributed.carry_bytes`` (bytes of the per-shard carries gathered)
    and opens the span ``distributed_scan``.  Inside an executable cache
    entry the counters count on the entry's first run only (the reference
    counts them once per traced executable); outside one, every scan
    counts.
    """
    length = elems[0].shape[0]
    shards = mesh.shape[axis_name]
    if shards < 2 or length < 2 * shards:
        return suffix_scan(fn, elems) if reverse else prefix_scan(fn, elems)

    with obs.trace_span("distributed_scan"):
        if obs.enabled():
            carry = sum(x.element_size() * math.prod(x.shape[1:])
                        for x in elems)
            inc_per_entry("distributed.shards", shards)
            inc_per_entry("distributed.carry_bytes", carry * shards)
        devices = mesh.axis_devices(axis_name)
        home = elems[0].device

        def dist(e):
            n = e[0].shape[0] // shards
            parts = [_remake(e, [x[i * n:(i + 1) * n].to(d) for x in e])
                     for i, d in enumerate(devices)]
            outs = distributed_scan(fn, parts, reverse=reverse,
                                    carry_dtype=carry_dtype, home=home)
            return _remake(e, [torch.cat([x.to(home) for x in xs])
                               for xs in zip(*outs)])

        cut = (length // shards) * shards
        if cut == length:
            return dist(elems)
        # Non-divisible T: distributed head + local tail, one broadcast
        # combine to stitch.
        head = _slice(elems, 0, None, cut)
        tail = _slice(elems, 0, cut)
        if reverse:
            tail_suf = suffix_scan(fn, tail)
            head_out = dist(head)
            head_out = fn(head_out, _bcast(_at(tail_suf, 0), head_out))
            return _remake(elems, [torch.cat([h, t]) for h, t in
                                   zip(head_out, tail_suf)])
        head_out = dist(head)
        tail_pre = prefix_scan(fn, tail)
        tail_out = fn(_bcast(_at(head_out, -1), tail_pre), tail_pre)
        return _remake(elems, [torch.cat([h, t]) for h, t in
                               zip(head_out, tail_out)])
