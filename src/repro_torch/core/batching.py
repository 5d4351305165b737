"""The deprecated batched entry points (shims over the Estimator surface).

* stacked records -> ``Estimator.solve(Problem.stacked(model, ts, ys))``
* ragged records  -> ``Estimator.solve(Problem.ragged(model, records))``

Each function below emits a ``DeprecationWarning`` and builds the
equivalent ``Problem``/``Estimator``.  ``mesh``/``batch_axis`` take
``None`` only: the port has no sharding yet.
"""
from __future__ import annotations

import warnings
from typing import List, Optional, Sequence, Union

from .estimator import Estimator, Problem, legacy_options
from .sde import LinearSDE, NonlinearSDE
from .types import Solution

Model = Union[LinearSDE, NonlinearSDE]


def _legacy_estimator(model, method, nsub, mode, iterations,
                      divergence_correction, mesh, batch_axis,
                      device) -> Estimator:
    if mesh is not None or batch_axis is not None:
        raise NotImplementedError(
            "mesh/batch_axis: the port has no sharding yet; pass None")
    return Estimator(
        model, method=method, device=device,
        options=legacy_options(model, method, nsub=nsub, mode=mode,
                               iterations=iterations,
                               divergence_correction=divergence_correction))


def map_estimate_batched(
    model: Model,
    ts,
    ys,
    *,
    method: str = "parallel_rts",
    nsub: int = 10,
    mode: str = "euler",
    iterations: int = 5,
    divergence_correction: bool = False,
    measurement_mask=None,
    mesh=None,
    batch_axis=None,
    device=None,
) -> Solution:
    """Deprecated shim: use ``Estimator(...).solve(Problem.stacked(...))``."""
    warnings.warn(
        "map_estimate_batched is deprecated; use repro_torch.core.Estimator "
        "with Problem.stacked",
        DeprecationWarning, stacklevel=2)
    est = _legacy_estimator(model, method, nsub, mode, iterations,
                            divergence_correction, mesh, batch_axis, device)
    return est.solve(Problem.stacked(model, ts, ys,
                                     measurement_mask=measurement_mask))


def map_estimate_ragged(
    model: Model,
    records: Sequence,
    *,
    method: str = "parallel_rts",
    nsub: int = 10,
    mode: str = "euler",
    iterations: int = 5,
    divergence_correction: bool = False,
    bucket_sizes: Optional[Sequence[int]] = None,
    pad_batch: bool = True,
    mesh=None,
    batch_axis=None,
    device=None,
) -> List[Solution]:
    """Deprecated shim: use ``Estimator(...).solve(Problem.ragged(...))``."""
    warnings.warn(
        "map_estimate_ragged is deprecated; use repro_torch.core.Estimator "
        "with Problem.ragged",
        DeprecationWarning, stacklevel=2)
    est = _legacy_estimator(model, method, nsub, mode, iterations,
                            divergence_correction, mesh, batch_axis, device)
    return est.solve(Problem.ragged(model, records,
                                    bucket_sizes=bucket_sizes,
                                    pad_batch=pad_batch))
