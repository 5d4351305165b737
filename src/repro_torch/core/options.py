"""Solver-owned option dataclasses for the estimation surface.

Every registered method declares the options IT understands as a frozen
dataclass registered alongside the solver
(:func:`repro_torch.core.registry.register_method`):

* :class:`SequentialOptions` -- ``mode`` only;
* :class:`ParallelOptions` -- ``mode`` + ``nsub`` (blocks of ``nsub``
  substeps feed the associative scan);
* :class:`TwoFilterOptions` -- parallel options + the two-filter knobs
  ``block0_fill`` / ``tf_fill`` / ``jitter`` of
  :func:`repro_torch.core.parallel.parallel_two_filter`;
* :class:`KernelOptions` -- parallel options + the CUDA-kernel knobs of the
  ``parallel_kernel`` method (``block_size`` threads per CUDA block,
  ``precision`` compute dtype of the kernel scan);
* :class:`DistributedOptions` -- parallel options + the mesh axes, shard
  count, carry dtype and fallback of the time-sharded ``distributed``
  method;
* :class:`IteratedOptions` -- the iterated-linearisation (nonlinear) layer:
  ``iterations`` / ``divergence_correction`` / ``linearization`` plus the
  ``inner`` options of the linear method that solves each linearised
  subproblem;
* :class:`SigmaPointOptions` -- the ``sigma_point`` method (iterated
  posterior-linearisation smoother): :class:`IteratedOptions` with a
  sigma-point SLR default linearisation and an ``inner_method`` naming the
  linear method each linearised subproblem runs on.

Unknown option names fail at construction (``TypeError`` from the
dataclass ``__init__``); bad values fail in ``__post_init__``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.linearize import get_linearization

MODES = ("euler", "rk4", "discrete")


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Base options shared by every grid solver.

    ``mode`` selects the element discretisation: ``"euler"`` / ``"rk4"``
    integrate the paper's ODEs (43) literally; ``"discrete"`` composes
    exact substep elements so parallel == sequential to round-off.
    """

    mode: str = "euler"

    def __post_init__(self) -> None:
        if self.mode not in MODES:
            raise ValueError(
                f"mode must be one of {MODES}, got {self.mode!r}")

    @classmethod
    def from_legacy(cls, **kwargs) -> "SolverOptions":
        """Build options from the legacy keyword arguments of the
        deprecated entry points, keeping only the fields THIS options
        class declares (and dropping ``None`` values)."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in kwargs.items()
                      if k in names and v is not None})


@dataclasses.dataclass(frozen=True)
class SequentialOptions(SolverOptions):
    """Options of the sequential RTS smoother."""


@dataclasses.dataclass(frozen=True)
class ParallelOptions(SolverOptions):
    """Options of the parallel (associative-scan) smoothers.

    ``nsub`` is the number of substeps per scan block (paper: n = 10); the
    grid length N must be a multiple of it.
    """

    nsub: int = 10

    def __post_init__(self) -> None:
        super().__post_init__()
        if not isinstance(self.nsub, int) or self.nsub < 1:
            raise ValueError(f"nsub must be a positive int, got {self.nsub!r}")


@dataclasses.dataclass(frozen=True)
class TwoFilterOptions(ParallelOptions):
    """Parallel two-filter smoother options (see
    :func:`repro_torch.core.parallel.parallel_two_filter` for semantics)."""

    block0_fill: str = "affine"
    tf_fill: str = "combine"
    jitter: float = 1e-9

    def __post_init__(self) -> None:
        super().__post_init__()
        if self.block0_fill not in ("affine", "min_initial"):
            raise ValueError(
                f"block0_fill must be 'affine' or 'min_initial', "
                f"got {self.block0_fill!r}")
        if self.tf_fill not in ("combine", "hjb_euler"):
            raise ValueError(
                f"tf_fill must be 'combine' or 'hjb_euler', "
                f"got {self.tf_fill!r}")


KERNEL_PRECISIONS = ("default", "float32", "float64")


@dataclasses.dataclass(frozen=True)
class KernelOptions(ParallelOptions):
    """Options of the kernel-backed parallel smoother (``parallel_kernel``).

    ``block_size`` is the number of threads per CUDA block of the scan
    kernel (a multiple of 32, at most 256 so that a block fits the register
    file at the kernel's register count).  ``precision`` is the kernel
    compute dtype: ``"default"`` keeps the element dtype (float64 runs
    natively on the card), ``"float32"`` / ``"float64"`` cast the scan's
    elements and cast the result back.
    """

    block_size: int = 128
    precision: str = "default"

    def __post_init__(self) -> None:
        super().__post_init__()
        if not (isinstance(self.block_size, int)
                and 32 <= self.block_size <= 256
                and self.block_size % 32 == 0):
            raise ValueError(
                f"block_size must be a multiple of 32 in [32, 256], "
                f"got {self.block_size!r}")
        if self.precision not in KERNEL_PRECISIONS:
            raise ValueError(
                f"precision must be one of {KERNEL_PRECISIONS}, "
                f"got {self.precision!r}")


CARRY_DTYPES = ("default", "float32", "float64")
FALLBACKS = ("auto", "error")


@dataclasses.dataclass(frozen=True)
class DistributedOptions(ParallelOptions):
    """Options of the time-axis-sharded parallel smoother (``distributed``).

    ``time_axis`` names the mesh axis the block scans are sharded over;
    ``batch_axes`` names the mesh axes the stacked/ragged record axis may
    be sharded over (intersected with the mesh's axes at solve time, so
    the same options serve a time-only and a 2-D mesh).
    ``devices_per_time`` pins the time-shard count of a default mesh
    (``None`` = every visible device of the estimator's type); an
    explicit or ambient mesh with another ``time_axis`` extent is an
    error, not a silent reshard.  ``carry_dtype`` is the dtype of the
    O(P)-sequential scan over the gathered per-shard carries
    (``"default"`` keeps the element dtype).  ``fallback="auto"`` runs the
    single-device parallel scan when fewer than 2 time shards are
    available; ``"error"`` raises instead.
    """

    time_axis: str = "time"
    batch_axes: tuple = ("data",)
    devices_per_time: Optional[int] = None
    carry_dtype: str = "default"
    fallback: str = "auto"

    def __post_init__(self) -> None:
        super().__post_init__()
        if not isinstance(self.time_axis, str) or not self.time_axis:
            raise ValueError(
                f"time_axis must be a non-empty str, got {self.time_axis!r}")
        if isinstance(self.batch_axes, list):
            object.__setattr__(self, "batch_axes", tuple(self.batch_axes))
        if not isinstance(self.batch_axes, tuple) or not all(
                isinstance(a, str) and a for a in self.batch_axes):
            raise ValueError(
                f"batch_axes must be a tuple of non-empty axis names, "
                f"got {self.batch_axes!r}")
        if self.time_axis in self.batch_axes:
            raise ValueError(
                f"time_axis {self.time_axis!r} cannot also be a batch axis")
        if self.devices_per_time is not None and (
                not isinstance(self.devices_per_time, int)
                or self.devices_per_time < 1):
            raise ValueError(
                f"devices_per_time must be None or a positive int, "
                f"got {self.devices_per_time!r}")
        if self.carry_dtype not in CARRY_DTYPES:
            raise ValueError(
                f"carry_dtype must be one of {CARRY_DTYPES}, "
                f"got {self.carry_dtype!r}")
        if self.fallback not in FALLBACKS:
            raise ValueError(
                f"fallback must be one of {FALLBACKS}, got {self.fallback!r}")

    def resolve_carry_dtype(self) -> Optional[torch.dtype]:
        """The dtype of the carry scan, or ``None`` to keep the element
        dtype."""
        if self.carry_dtype == "default":
            return None
        return getattr(torch, self.carry_dtype)


@dataclasses.dataclass(frozen=True)
class IteratedOptions:
    """Options of the iterated-linearisation layer (nonlinear models only).

    ``inner`` carries the options of the method solving each linearised
    subproblem; ``None`` means the method's defaults.  Passing a bare
    method-options instance to :class:`~repro_torch.core.Estimator` for a
    nonlinear model is the same as ``IteratedOptions(inner=that)``.

    ``linearization`` selects how each iteration linearises the model: a
    registered name (``"taylor"``, ``"unscented"``, ``"cubature"``,
    ``"gauss_hermite"``) or a
    :class:`repro_torch.linearize.Linearization` instance, resolved to an
    instance at construction so that a bad name fails here.
    """

    iterations: int = 5
    divergence_correction: bool = False
    inner: Optional[SolverOptions] = None
    linearization: object = "taylor"

    def __post_init__(self) -> None:
        if not isinstance(self.iterations, int) or self.iterations < 1:
            raise ValueError(
                f"iterations must be a positive int, got {self.iterations!r}")
        if self.inner is not None and not isinstance(self.inner,
                                                     SolverOptions):
            raise TypeError(
                f"inner must be a SolverOptions instance, got "
                f"{type(self.inner).__name__}")
        object.__setattr__(self, "linearization",
                           get_linearization(self.linearization))

    def replace(self, **changes) -> "IteratedOptions":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class SigmaPointOptions(IteratedOptions):
    """Options of the ``sigma_point`` method: the iterated
    posterior-linearisation smoother (sigma-point SLR instead of Taylor).

    ``inner_method`` names the registered LINEAR method each linearised
    subproblem is solved with (``"parallel_rts"``, ``"sequential_rts"``,
    ``"parallel_kernel"``, ...); ``inner`` carries that method's options
    (``None`` = its defaults).  ``linearization`` defaults to the
    unscented SLR family; any registered strategy -- including
    ``"taylor"``, which makes ``sigma_point`` the plain IEKS -- is
    accepted.
    """

    linearization: object = "unscented"
    inner_method: str = "parallel_rts"

    def __post_init__(self) -> None:
        super().__post_init__()
        if not isinstance(self.inner_method, str) or not self.inner_method:
            raise ValueError(
                f"inner_method must be a non-empty method name, "
                f"got {self.inner_method!r}")
