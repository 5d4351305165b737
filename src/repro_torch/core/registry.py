"""Method registry: one dispatch table for every MAP solver backend.

Each entry is a :class:`MethodSpec` pairing the solver callable with the
:class:`~repro_torch.core.options.SolverOptions` dataclass it owns:

    registry.register_method("my_method", solver, MyOptions)

where ``solver(grid: GridLQT, options: MyOptions) -> MAPSolution``.  A
method whose options class is an
:class:`~repro_torch.core.options.IteratedOptions` subclass is an iterated
nonlinear method (``MethodSpec.nonlinear``): it is not a grid solver, and
its options name the linear method (``inner_method``) that solves each
linearised subproblem.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple, Type

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
from .parallel import parallel_rts, parallel_two_filter
from .sequential import sequential_rts, sequential_two_filter
from .types import GridLQT, MAPSolution

Solver = Callable[[GridLQT, SolverOptions], MAPSolution]


class MethodSpec(NamedTuple):
    """A registered solver backend: name + solver + its options class."""

    name: str
    solver: Solver
    options_cls: Type[SolverOptions]

    def default_options(self) -> SolverOptions:
        return self.options_cls()

    @property
    def nonlinear(self) -> bool:
        """True for iterated nonlinear methods (options subclass
        ``IteratedOptions``): they need a nonlinear model and delegate each
        linearised subproblem to an inner linear method."""
        return issubclass(self.options_cls, IteratedOptions)


_METHODS: Dict[str, MethodSpec] = {}


def register_method(name: str, solver: Solver,
                    options_cls: Type[SolverOptions], *,
                    overwrite: bool = False) -> None:
    """Register ``solver(grid, options) -> MAPSolution`` under ``name``."""
    if not (isinstance(options_cls, type)
            and issubclass(options_cls, (SolverOptions, IteratedOptions))):
        raise TypeError(
            f"options_cls must be a SolverOptions subclass (or an "
            f"IteratedOptions subclass for nonlinear methods), got "
            f"{options_cls!r}")
    if name in _METHODS and not overwrite:
        raise ValueError(f"method {name!r} already registered")
    _METHODS[name] = MethodSpec(name, solver, options_cls)


def get_method(name: str) -> MethodSpec:
    try:
        return _METHODS[name]
    except KeyError:
        raise ValueError(
            f"method must be one of {method_names()}, got {name!r}"
        ) from None


def get_solver(name: str) -> Callable:
    """Back-compat accessor: a ``(grid, nsub, mode)`` adapter around the
    registered solver (fields the method's options do not declare are
    dropped)."""
    spec = get_method(name)

    def solver(grid, nsub, mode):
        return spec.solver(grid,
                           spec.options_cls.from_legacy(nsub=nsub, mode=mode))

    return solver


def method_names() -> Tuple[str, ...]:
    return tuple(_METHODS)


def _parallel_kernel_solver(grid: GridLQT, o: KernelOptions) -> MAPSolution:
    """RTS smoother with the backward scan run by the CUDA scan kernel
    (the whole tree, every record, in one launch); states wider than the
    register kernel takes run the wide kernel, whose pairwise entry also
    does their in-block work (``ops.in_block_steps``).

    The kernel package is imported lazily so ``repro_torch.core`` never
    depends on ``repro_torch.kernels`` at import time.
    """
    from repro_torch.kernels.lqt_combine.ops import (
        in_block_steps,
        kernel_suffix_scan,
    )

    def suffix(elems):
        return kernel_suffix_scan(elems, block_size=o.block_size,
                                  precision=o.precision)

    return parallel_rts(
        grid, o.nsub, o.mode, suffix_scan_fn=suffix,
        steps=in_block_steps(grid.nx))


def _distributed_solver(grid: GridLQT, o: DistributedOptions, *,
                        mesh=None) -> MAPSolution:
    """RTS smoother with both global scans (the eq.-(42) suffix scan and
    the affine prefix scan) sharded over a named time axis
    (:func:`repro_torch.core.pscan.sharded_scan`): a local scan per shard,
    the P per-shard carries gathered, a sequential carry scan, a local
    fix-up -- span O(log(T/P) + P).  The combines are the plain ones, as
    in the reference: no kernel runs here.

    ``mesh`` is the mesh the caller resolved (the Estimator passes the
    one it resolved for the solve).  Without it the solver resolves one
    as the reference does: an ambient ``MeshSpec.activate()`` mesh
    carrying ``options.time_axis`` (see
    :func:`repro_torch.distributed.resolve_time_mesh`), else a default
    time-only mesh over ``devices_per_time`` (or all) distinct devices of
    the grid's device type.  With fewer than 2 time shards the solver
    runs the single-device parallel scan (``fallback="auto"``) or raises
    (``fallback="error"``).
    """
    from repro_torch.distributed.sharding import resolve_time_mesh

    from . import pscan
    from .combine import affine_combine, lqt_combine

    if mesh is None:
        mesh = resolve_time_mesh(o.time_axis,
                                 devices_per_time=o.devices_per_time,
                                 device_type=grid.F.device.type)
    if mesh is None:
        if o.fallback == "error":
            raise RuntimeError(
                f"method='distributed' needs >= 2 devices on mesh axis "
                f"{o.time_axis!r} (fallback='error'); pass "
                f"fallback='auto' to degrade to the single-device scan")
        return parallel_rts(grid, o.nsub, o.mode)

    carry_dtype = o.resolve_carry_dtype()

    def suffix(elems):
        return pscan.sharded_scan(
            lqt_combine, elems, mesh=mesh, axis_name=o.time_axis,
            reverse=True, carry_dtype=carry_dtype)

    def prefix(elems):
        return pscan.sharded_scan(
            affine_combine, elems, mesh=mesh, axis_name=o.time_axis,
            carry_dtype=carry_dtype)

    return parallel_rts(grid, o.nsub, o.mode,
                        suffix_scan_fn=suffix, prefix_scan_fn=prefix)


register_method(
    "parallel_rts",
    lambda grid, o: parallel_rts(grid, o.nsub, o.mode),
    ParallelOptions)
register_method("parallel_kernel", _parallel_kernel_solver, KernelOptions)
register_method("distributed", _distributed_solver, DistributedOptions)
register_method(
    "parallel_two_filter",
    lambda grid, o: parallel_two_filter(
        grid, o.nsub, o.mode, jitter=o.jitter,
        block0_fill=o.block0_fill, tf_fill=o.tf_fill),
    TwoFilterOptions)


def _sigma_point_solver(grid: GridLQT, o: SigmaPointOptions) -> MAPSolution:
    """``sigma_point`` is not a grid solver: the Estimator resolves its
    ``inner_method`` and runs the iterated loop around THAT solver.  Only
    a direct ``spec.solver(grid, options)`` call -- which would silently
    skip the linearisation loop -- lands here."""
    raise TypeError(
        "method='sigma_point' is an iterated nonlinear method, not a grid "
        "solver; use Estimator(model, method='sigma_point').solve(problem) "
        "with a NonlinearSDE model")


register_method("sigma_point", _sigma_point_solver, SigmaPointOptions)
register_method(
    "sequential_rts",
    lambda grid, o: sequential_rts(grid, o.mode),
    SequentialOptions)
register_method(
    "sequential_two_filter",
    lambda grid, o: sequential_two_filter(grid, o.mode),
    SequentialOptions)
