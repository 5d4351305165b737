"""Carry the reference package's state across as numpy arrays.

The port never imports the reference package: a caller (for example a
parity test) turns the reference's model, grid, elements or parameter
tree into numpy arrays (``numpy.asarray`` of each field) and these
helpers build the port's objects from them, on an explicit device and
dtype.
"""
from __future__ import annotations

from typing import Mapping, Sequence, Union

import numpy as np
import torch

from .core.sde import LinearSDE, NonlinearSDE
from .core.types import GridLQT, LQTElement

Arrays = Union[Mapping[str, object], Sequence[object]]

_SDE_FIELDS = ("F", "c", "H", "r", "Q", "R", "m0", "P0")


def _to(a, device, dtype):
    if a is None or callable(a):
        return a
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def _fields(arrays: Arrays, names) -> list:
    if isinstance(arrays, Mapping):
        return [arrays.get(n) for n in names]
    vals = list(arrays)      # not len(arrays): element types override it
    return vals + [None] * (len(names) - len(vals))


def linear_sde_from_numpy(arrays: Arrays, *, device="cpu",
                          dtype: torch.dtype = torch.float64) -> LinearSDE:
    """``F, c, H, r, Q, R, m0, P0`` (a mapping by name or a sequence in
    that order) -> :class:`LinearSDE`.  A coefficient may instead be a
    torch callable of t, kept as it is (a time-varying model)."""
    return LinearSDE(*(_to(a, device, dtype)
                       for a in _fields(arrays, _SDE_FIELDS)))


def nonlinear_sde_from_numpy(arrays: Arrays, f, h, *, device="cpu",
                             dtype: torch.dtype = torch.float64
                             ) -> NonlinearSDE:
    """``Q, R, m0, P0`` (a mapping by name or a sequence in that order)
    and the torch callables ``f(x, t)``, ``h(x, t)`` ->
    :class:`NonlinearSDE`.  ``Q``/``R`` may instead be torch callables of
    t, kept as they are."""
    return NonlinearSDE(f, h, *(_to(a, device, dtype) for a in _fields(
        arrays, ("Q", "R", "m0", "P0"))))


def grid_from_numpy(arrays: Arrays, *, device="cpu",
                    dtype: torch.dtype = torch.float64) -> GridLQT:
    """The eleven ``GridLQT`` fields (by name, or in field order; ``lin``
    may be missing or ``None``) -> :class:`GridLQT`."""
    return GridLQT(*(_to(a, device, dtype)
                     for a in _fields(arrays, GridLQT._fields)))


def elements_from_numpy(arrays: Arrays, *, device="cpu",
                        dtype: torch.dtype = torch.float64) -> LQTElement:
    """``A, b, C, eta, J`` (by name or in order) -> :class:`LQTElement`."""
    return LQTElement(*(_to(a, device, dtype)
                        for a in _fields(arrays, LQTElement._fields)))


def _np_to_tensor(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.as_tensor refuses; float32
        # holds every bfloat16 value exactly.
        t = torch.as_tensor(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.as_tensor(np.array(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def lm_params_from_numpy(tree, *, device="cpu", dtype=None) -> dict:
    """A language-model parameter tree (nested dicts of numpy arrays, the
    reference's names and layouts) -> the port's tree of tensors on
    ``device``, cast to ``dtype`` (``None`` keeps each array's dtype;
    bfloat16 arrays stay bfloat16)."""
    if isinstance(tree, Mapping):
        return {k: lm_params_from_numpy(v, device=device, dtype=dtype)
                for k, v in tree.items()}
    return _np_to_tensor(tree, device, dtype)
