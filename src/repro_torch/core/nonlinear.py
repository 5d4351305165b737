"""Iterated linearisation for nonlinear models (section 4.4).

Continuous-time iterated extended Kalman smoother: linearise (1) about the
current nominal trajectory, solve the resulting linear-affine MAP problem
with the sequential or PARALLEL smoother, re-linearise, repeat.  Every
iteration is parallel-in-time when the inner method is a parallel solver,
which is the paper's Fig.-2 experiment (5 iterations on the
coordinated-turn model).

Records ride as tensor dims after the time axis, as everywhere in the
port: one pass linearises and solves every record at once.

:func:`iterated_solve` is the engine room of
:class:`repro_torch.core.Estimator`; :func:`iterated_map` is the
deprecated entry point, a shim around the Estimator surface.
"""
from __future__ import annotations

import warnings
from typing import Callable, Optional, Tuple

import torch

from repro_torch.linearize import get_linearization
from repro_torch.obs.tracing import trace_range

from .combine import _solve_vec
from .sde import NonlinearSDE, Prior, grid_lqt_from_nonlinear, om_cost_nonlinear
from .types import MAPSolution, Tensor


def iterated_solve(
    model: NonlinearSDE,
    ts: Tensor,
    y: Tensor,
    solver: Callable,
    *,
    iterations: int = 5,
    divergence_correction: bool = False,
    x_init: Optional[Tensor] = None,
    measurement_mask: Optional[Tensor] = None,
    prior: Optional[Prior] = None,
    track_costs: bool = True,
    linearization=None,
) -> Tuple[MAPSolution, Optional[Tensor], Optional[Tensor]]:
    """Continuous-time iterated MAP estimation (paper section 5.2).

    ``ts`` ``(N+1, *R)`` and ``y`` ``(N, *R, ny)``; ``solver`` maps a
    linearised :class:`~repro_torch.core.types.GridLQT` to a
    :class:`MAPSolution` (method + options already bound).  ``iterations``
    Gauss-Newton style passes (the paper uses 5); the initial nominal
    trajectory defaults to the constant prior mean.  ``x_init`` is a
    nominal trajectory broadcastable to ``(N+1, *R, nx)``: one state
    ``(nx,)`` for every time and record, or a full trajectory.  ``measurement_mask``
    (``(N, *R)`` of 0/1) and ``prior`` ``(S0, v0)`` apply to every
    linearised subproblem and to the cost trace.

    Returns ``(solution, cost_trace, step_norms)``, the traces
    ``(iterations, *R)``: ``cost_trace[i]`` is the true nonlinear
    Onsager-Machlup cost of the iterate of pass ``i+1`` and
    ``step_norms[i]`` its RMS update ``sqrt(mean((x_{i+1} - x_i)^2))`` per
    record.  ``track_costs=False`` skips both (``(solution, None, None)``).
    ``linearization`` selects the strategy (``None`` = Taylor, the IEKS).
    """
    linearization = get_linearization(linearization)
    shape = ts.shape[:1] + ts.shape[1:] + (model.nx,)         # (N+1, *R, nx)
    if x_init is None:
        x_init = (model.m0 if prior is None
                  else _solve_vec(prior[0], prior[1]))
    x = x_init.expand(shape)

    def cost_of(xx):
        return om_cost_nonlinear(
            model, ts, y, xx, divergence_correction=divergence_correction,
            measurement_mask=measurement_mask, prior=prior)

    costs, steps = [], []
    # ``iterations`` linearise + solve passes; the reference runs the first
    # iterations - 1 in a lax.scan and the last outside it -- the same
    # passes in the same order.
    for _ in range(iterations):
        # each pass keeps only the previous one's trajectory: its grid and
        # its values (S, v) are freed before this pass's linearisation,
        # not when this pass's own replace them
        sol = None
        with trace_range("solve.linearise"):
            grid = grid_lqt_from_nonlinear(
                model, ts, y, x, divergence_correction=divergence_correction,
                measurement_mask=measurement_mask, prior=prior,
                linearization=linearization)
        sol = solver(grid)
        del grid
        if track_costs:
            with trace_range("solve.cost"):
                costs.append(cost_of(sol.x))
                steps.append(torch.sqrt(torch.mean(torch.square(sol.x - x),
                                                   dim=(0, -1))))
        x = sol.x
    if not track_costs:
        return sol, None, None
    with trace_range("solve.cost"):
        return sol, torch.stack(costs), torch.stack(steps)


def iterated_map(
    model: NonlinearSDE,
    ts,
    y,
    *,
    iterations: int = 5,
    method: str = "parallel_rts",
    nsub: int = 10,
    mode: str = "euler",
    divergence_correction: bool = False,
    x_init=None,
    measurement_mask=None,
    device=None,
):
    """Deprecated shim: use ``Estimator(model, method=..., options=
    IteratedOptions(...), device=...).solve(Problem.single(...))``."""
    warnings.warn(
        "iterated_map is deprecated; use repro_torch.core.Estimator with "
        "IteratedOptions and Problem.single",
        DeprecationWarning, stacklevel=2)
    from .estimator import Estimator, Problem, legacy_options

    est = Estimator(model, method=method, device=device,
                    options=legacy_options(
                        model, method, nsub=nsub, mode=mode,
                        iterations=iterations,
                        divergence_correction=divergence_correction))
    return est.solve(Problem.single(model, ts, y,
                                    measurement_mask=measurement_mask,
                                    x_init=x_init))
