"""The deprecated single-record entry point :func:`map_estimate`.

The surface is ``Estimator``/``Problem``/``Solution``:

    from repro_torch.core import Estimator, Problem

    est = Estimator(model, method="parallel_rts",
                    options=ParallelOptions(nsub=10, mode="discrete"))
    sol = est.solve(Problem.single(model, ts, y))

:func:`map_estimate` and the ``METHODS`` name remain, as in the reference
package, as deprecation shims over that surface: each emits a
``DeprecationWarning`` and builds the equivalent ``Problem``/``Estimator``.
"""
from __future__ import annotations

import warnings
from typing import Optional, Union

from .estimator import Estimator, Problem, legacy_options
from .registry import method_names
from .sde import LinearSDE, NonlinearSDE


def map_estimate(
    model: Union[LinearSDE, NonlinearSDE],
    ts,
    y,
    *,
    method: str = "parallel_rts",
    nsub: int = 10,
    mode: str = "euler",
    iterations: int = 5,
    divergence_correction: bool = False,
    measurement_mask=None,
    device=None,
):
    """Deprecated shim: use ``Estimator(model, method=..., options=...,
    device=...).solve(Problem.single(model, ts, y))`` instead."""
    warnings.warn(
        "map_estimate is deprecated; use repro_torch.core.Estimator with "
        "Problem.single",
        DeprecationWarning, stacklevel=2)
    est = Estimator(model, method=method, device=device,
                    options=legacy_options(
                        model, method, nsub=nsub, mode=mode,
                        iterations=iterations,
                        divergence_correction=divergence_correction))
    return est.solve(Problem.single(model, ts, y,
                                    measurement_mask=measurement_mask))


def __getattr__(name: str):
    # METHODS is a live (deprecated) view of the registry, so that methods
    # registered later are in it; call method_names() instead.
    if name == "METHODS":
        warnings.warn(
            "METHODS is deprecated; call repro_torch.core.method_names() "
            "for the live method list", DeprecationWarning, stacklevel=2)
        return method_names()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
