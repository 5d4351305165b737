"""Continuous-time MAP trajectory estimation, parallel in time (PyTorch).

The public surface mirrors the reference package's:

    est = Estimator(model, method="parallel_kernel",
                    options=KernelOptions(nsub=10, mode="discrete"))
    sol = est.solve(Problem.single(model, ts, y))   # -> Solution

A :class:`NonlinearSDE` model is solved by iterated linearisation
(:class:`IteratedOptions` wraps the inner method's options).
"""
from .combine import (
    affine_combine,
    apply_element_to_value,
    elem_min_initial,
    lqt_combine,
    value_as_element,
)
from .estimator import Estimator, Problem, resolve_device
from .nonlinear import iterated_solve
from .options import (
    IteratedOptions,
    KernelOptions,
    ParallelOptions,
    SequentialOptions,
    SolverOptions,
    TwoFilterOptions,
)
from .oracle import qp_map_estimate, qp_map_from_grid
from .parallel import parallel_backward, parallel_rts, parallel_two_filter
from .pscan import associative_scan, prefix_scan, suffix_scan
from .registry import MethodSpec, get_method, method_names, register_method
from .sde import (
    LinearSDE,
    NonlinearSDE,
    build_grid_lqt,
    grid_lqt_from_linear,
    grid_lqt_from_nonlinear,
    om_cost_grid,
    om_cost_linear,
    om_cost_nonlinear,
    simulate_linear,
    simulate_nonlinear,
    time_grid,
)
from .sequential import (
    affine_recovery_maps,
    sequential_backward,
    sequential_rts,
    sequential_two_filter,
    two_filter_combine,
)
from .types import (
    AffineElement,
    GridLQT,
    LQTElement,
    MAPSolution,
    Solution,
    ValueFn,
)

__all__ = [
    "AffineElement",
    "Estimator",
    "GridLQT",
    "IteratedOptions",
    "KernelOptions",
    "LQTElement",
    "LinearSDE",
    "MAPSolution",
    "MethodSpec",
    "NonlinearSDE",
    "ParallelOptions",
    "Problem",
    "SequentialOptions",
    "Solution",
    "SolverOptions",
    "TwoFilterOptions",
    "ValueFn",
    "affine_combine",
    "affine_recovery_maps",
    "apply_element_to_value",
    "associative_scan",
    "build_grid_lqt",
    "elem_min_initial",
    "get_method",
    "grid_lqt_from_linear",
    "grid_lqt_from_nonlinear",
    "iterated_solve",
    "lqt_combine",
    "method_names",
    "om_cost_grid",
    "om_cost_linear",
    "om_cost_nonlinear",
    "parallel_backward",
    "parallel_rts",
    "parallel_two_filter",
    "prefix_scan",
    "qp_map_estimate",
    "qp_map_from_grid",
    "register_method",
    "resolve_device",
    "sequential_backward",
    "sequential_rts",
    "sequential_two_filter",
    "simulate_linear",
    "simulate_nonlinear",
    "suffix_scan",
    "time_grid",
    "two_filter_combine",
    "value_as_element",
]
