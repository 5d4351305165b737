"""Nested containers of tensors: dicts, tuples, lists and NamedTuples.

The port's parameter, optimizer and cache trees are such containers.  A
dict's keys are visited in sorted order, the reference's tree order, and
``None`` is an empty subtree, as in JAX.

The walks are module-level functions that take their accumulator or
iterator as an argument: a nested function that calls itself would hold
itself through its own closure cell, a reference cycle that keeps every
visited leaf alive until Python's cyclic garbage collector runs.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _walk(t, path: tuple, out: list) -> None:
    if isinstance(t, dict):
        for k in sorted(t):
            _walk(t[k], path + (k,), out)
    elif isinstance(t, (tuple, list)):
        names = getattr(t, "_fields", None) or range(len(t))
        for k, v in zip(names, t):
            _walk(v, path + (k,), out)
    elif t is not None:
        out.append((path, t))


def flatten(tree) -> List[Tuple[tuple, Any]]:
    """``[(path, leaf), ...]``: each leaf with its path of dict keys,
    NamedTuple field names and sequence indices."""
    out = []
    _walk(tree, (), out)
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten(tree)]


def _build(t, it: Iterator) -> Any:
    if isinstance(t, dict):
        return {k: _build(t[k], it) for k in sorted(t)}
    if isinstance(t, (tuple, list)):
        items = [_build(v, it) for v in t]
        return type(t)(*items) if hasattr(t, "_fields") else type(t)(items)
    return None if t is None else next(it)


def unflatten(like, values) -> Any:
    """A tree of ``like``'s structure holding ``values`` in leaf order."""
    it = iter(values)
    out = _build(like, it)
    if next(it, None) is not None:
        raise ValueError("more values than the tree has leaves")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and of trees of the same
    structure, leaf by leaf."""
    return unflatten(tree, [fn(*xs) for xs in
                            zip(*(leaves(t) for t in (tree, *rest)))])
