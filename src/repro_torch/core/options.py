"""Solver-owned option dataclasses for the estimation surface.

Every registered method declares the options IT understands as a frozen
dataclass registered alongside the solver
(:func:`repro_torch.core.registry.register_method`):

* :class:`SequentialOptions` -- ``mode`` only;
* :class:`ParallelOptions` -- ``mode`` + ``nsub`` (blocks of ``nsub``
  substeps feed the associative scan);
* :class:`KernelOptions` -- parallel options + the CUDA-kernel knobs of the
  ``parallel_kernel`` method (``block_size`` threads per CUDA block,
  ``precision`` compute dtype of the kernel scan).

Unknown option names fail at construction (``TypeError`` from the
dataclass ``__init__``); bad values fail in ``__post_init__``.
"""
from __future__ import annotations

import dataclasses

MODES = ("euler", "rk4", "discrete")


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Base options shared by every grid solver.

    ``mode`` selects the element discretisation: ``"euler"`` / ``"rk4"``
    integrate the paper's ODEs (43) literally (not ported yet: a solve
    raises ``NotImplementedError``); ``"discrete"`` composes exact substep
    elements so parallel == sequential to round-off.
    """

    mode: str = "euler"

    def __post_init__(self) -> None:
        if self.mode not in MODES:
            raise ValueError(
                f"mode must be one of {MODES}, got {self.mode!r}")


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


KERNEL_PRECISIONS = ("default", "float32", "float64")


@dataclasses.dataclass(frozen=True)
class KernelOptions(ParallelOptions):
    """Options of the kernel-backed parallel smoother (``parallel_kernel``).

    ``block_size`` is the number of threads per CUDA block of the combine
    kernel (one thread per element pair; a multiple of 32, at most 256 so
    that a block fits the register file at the kernel's register count).
    ``precision`` is the kernel compute dtype: ``"default"`` keeps the
    element dtype (float64 runs natively on the card), ``"float32"`` /
    ``"float64"`` cast the lane-major scan and cast the result back.
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
