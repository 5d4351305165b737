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
    IteratedOptions,
    KernelOptions,
    ParallelOptions,
    SequentialOptions,
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


def method_names() -> Tuple[str, ...]:
    return tuple(_METHODS)


def _parallel_kernel_solver(grid: GridLQT, o: KernelOptions) -> MAPSolution:
    """RTS smoother with the backward scan run by the CUDA scan kernel
    (the whole tree, every record, in one launch).

    The kernel package is imported lazily so ``repro_torch.core`` never
    depends on ``repro_torch.kernels`` at import time.
    """
    from repro_torch.kernels.lqt_combine.ops import kernel_suffix_scan

    def suffix(elems):
        return kernel_suffix_scan(elems, block_size=o.block_size,
                                  precision=o.precision)

    return parallel_rts(grid, o.nsub, o.mode, suffix_scan_fn=suffix)


register_method(
    "parallel_rts",
    lambda grid, o: parallel_rts(grid, o.nsub, o.mode),
    ParallelOptions)
register_method("parallel_kernel", _parallel_kernel_solver, KernelOptions)
register_method(
    "parallel_two_filter",
    lambda grid, o: parallel_two_filter(
        grid, o.nsub, o.mode, jitter=o.jitter,
        block0_fill=o.block0_fill, tf_fill=o.tf_fill),
    TwoFilterOptions)
register_method(
    "sequential_rts",
    lambda grid, o: sequential_rts(grid, o.mode),
    SequentialOptions)
register_method(
    "sequential_two_filter",
    lambda grid, o: sequential_two_filter(grid, o.mode),
    SequentialOptions)
