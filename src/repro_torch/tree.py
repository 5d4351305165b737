"""Nested containers of tensors: dicts, tuples, lists and NamedTuples.

The port's parameter, optimizer and cache trees are such containers.  A
dict's keys are visited in sorted order, the reference's tree order, and
``None`` is an empty subtree, as in JAX.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def flatten(tree) -> List[Tuple[tuple, Any]]:
    """``[(path, leaf), ...]``: each leaf with its path of dict keys,
    NamedTuple field names and sequence indices."""
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        elif isinstance(t, (tuple, list)):
            names = getattr(t, "_fields", None) or range(len(t))
            for k, v in zip(names, t):
                walk(v, path + (k,))
        elif t is not None:
            out.append((path, t))

    walk(tree, ())
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten(tree)]


def unflatten(like, values) -> Any:
    """A tree of ``like``'s structure holding ``values`` in leaf order."""
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (tuple, list)):
            items = [build(v) for v in t]
            return type(t)(*items) if hasattr(t, "_fields") else type(t)(items)
        return None if t is None else next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more values than the tree has leaves")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and of trees of the same
    structure, leaf by leaf."""
    return unflatten(tree, [fn(*xs) for xs in
                            zip(*(leaves(t) for t in (tree, *rest)))])
