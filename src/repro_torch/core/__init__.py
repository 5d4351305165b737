"""Continuous-time MAP trajectory estimation, parallel in time (PyTorch).

The public surface mirrors the reference package's:

    est = Estimator(model, method="parallel_kernel",
                    options=KernelOptions(nsub=10, mode="discrete"))
    sol = est.solve(Problem.single(model, ts, y))   # -> Solution

A :class:`NonlinearSDE` model is solved by iterated linearisation
(:class:`IteratedOptions` wraps the inner method's options;
``method="sigma_point"`` with :class:`SigmaPointOptions` is the
posterior-linearisation smoother).  Records of unequal lengths are solved
by pad-and-bucket (:meth:`Problem.ragged`).  Each estimator keeps one
cached solve per problem layout (:class:`ExecutableCache`,
:func:`cache_stats`); ``est.lower(problem).compile()`` returns it for
ahead-of-time use.  ``Estimator(..., mesh=...)``
spreads records over a device mesh's batch axis, and
``method="distributed"`` (:class:`DistributedOptions`) the time axis over
its time axis (:mod:`repro_torch.distributed`).  The old function entry points
(``map_estimate`` & co.) remain as deprecation shims.
"""
from .api import map_estimate
from .batching import map_estimate_batched, map_estimate_ragged
from .combine import (
    affine_combine,
    apply_element_to_value,
    elem_min_initial,
    lqt_combine,
    value_as_element,
)
from .estimator import (
    Compiled,
    Estimator,
    ExecutableCache,
    Lowered,
    Problem,
    cache_stats,
    clear_cache,
    legacy_options,
    resolve_device,
)
from .nonlinear import iterated_map, iterated_solve
from .options import (
    DistributedOptions,
    IteratedOptions,
    KernelOptions,
    ParallelOptions,
    SequentialOptions,
    SigmaPointOptions,
    SolverOptions,
    TwoFilterOptions,
)
from .oracle import qp_map_estimate, qp_map_from_grid
from .padding import bucket_length, pad_record, slice_solution
from .parallel import parallel_backward, parallel_rts, parallel_two_filter
from .pscan import (
    associative_scan,
    distributed_scan,
    prefix_scan,
    sharded_scan,
    suffix_scan,
)
from .registry import (
    MethodSpec,
    get_method,
    get_solver,
    method_names,
    register_method,
)
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
    BucketInfo,
    GridLQT,
    LQTElement,
    MAPSolution,
    PaddingReport,
    Solution,
    ValueFn,
)

__all__ = [
    "AffineElement",
    "BucketInfo",
    "Compiled",
    "DistributedOptions",
    "Estimator",
    "ExecutableCache",
    "GridLQT",
    "IteratedOptions",
    "KernelOptions",
    "LQTElement",
    "LinearSDE",
    "Lowered",
    "MAPSolution",
    "METHODS",
    "MethodSpec",
    "NonlinearSDE",
    "PaddingReport",
    "ParallelOptions",
    "Problem",
    "SequentialOptions",
    "SigmaPointOptions",
    "Solution",
    "SolverOptions",
    "TwoFilterOptions",
    "ValueFn",
    "affine_combine",
    "affine_recovery_maps",
    "apply_element_to_value",
    "associative_scan",
    "bucket_length",
    "build_grid_lqt",
    "cache_stats",
    "clear_cache",
    "distributed_scan",
    "elem_min_initial",
    "get_method",
    "get_solver",
    "grid_lqt_from_linear",
    "grid_lqt_from_nonlinear",
    "iterated_map",
    "iterated_solve",
    "legacy_options",
    "lqt_combine",
    "map_estimate",
    "map_estimate_batched",
    "map_estimate_ragged",
    "method_names",
    "om_cost_grid",
    "om_cost_linear",
    "om_cost_nonlinear",
    "pad_record",
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
    "sharded_scan",
    "simulate_linear",
    "simulate_nonlinear",
    "slice_solution",
    "suffix_scan",
    "time_grid",
    "two_filter_combine",
    "value_as_element",
]


def __getattr__(name: str):
    if name == "METHODS":      # deprecated live view; see api.__getattr__
        from . import api
        return api.METHODS
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
