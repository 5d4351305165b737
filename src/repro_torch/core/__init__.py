"""Continuous-time MAP trajectory estimation, parallel in time (PyTorch).

The public surface mirrors the reference package's:

    est = Estimator(model, method="parallel_kernel",
                    options=KernelOptions(nsub=10, mode="discrete"))
    sol = est.solve(Problem.single(model, ts, y))   # -> Solution
"""
from .combine import (
    affine_combine,
    apply_element_to_value,
    lqt_combine,
    value_as_element,
)
from .estimator import Estimator, Problem, resolve_device
from .options import (
    KernelOptions,
    ParallelOptions,
    SequentialOptions,
    SolverOptions,
)
from .parallel import parallel_backward, parallel_rts
from .pscan import associative_scan, prefix_scan, suffix_scan
from .registry import MethodSpec, get_method, method_names, register_method
from .sde import (
    LinearSDE,
    build_grid_lqt,
    grid_lqt_from_linear,
    om_cost_grid,
    om_cost_linear,
    simulate_linear,
    time_grid,
)
from .sequential import affine_recovery_maps, sequential_backward, sequential_rts
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
    "KernelOptions",
    "LQTElement",
    "LinearSDE",
    "MAPSolution",
    "MethodSpec",
    "ParallelOptions",
    "Problem",
    "SequentialOptions",
    "Solution",
    "SolverOptions",
    "ValueFn",
    "affine_combine",
    "affine_recovery_maps",
    "apply_element_to_value",
    "associative_scan",
    "build_grid_lqt",
    "get_method",
    "grid_lqt_from_linear",
    "lqt_combine",
    "method_names",
    "om_cost_grid",
    "om_cost_linear",
    "parallel_backward",
    "parallel_rts",
    "prefix_scan",
    "register_method",
    "resolve_device",
    "sequential_backward",
    "sequential_rts",
    "simulate_linear",
    "suffix_scan",
    "time_grid",
    "value_as_element",
]
