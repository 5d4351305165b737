"""Core tensor types for continuous-time MAP estimation (PyTorch port).

Notation follows the paper (Razavi, Garcia-Fernandez, Sarkka 2025):

* ``LQTElement``    -- conditional value function parameters (A, b, C, eta, J)
                       of eq. (41).
* ``AffineElement`` -- transition pair (Phi, beta) of eqs. (20)/(45)-(46).
* ``ValueFn``       -- quadratic value function 1/2 phi^T S phi - v^T phi
                       (eq. 14), the information-form filter state.
* ``GridLQT``       -- the time-REVERSED, grid-discretised linear-affine
                       optimal control problem (eqs. 3-6 and 13).

Layout: every time-indexed field keeps the reference package's per-record
layout with the time axis FIRST (``(N, nx, nx)``, ``(N, nx)``, ``(N,)``).
A batch of records is carried as extra dimensions right after the time
axis (``(N, R, nx, nx)``), so the time axis stays dim 0 for every field and
the combines broadcast over the record dims.  Fields without a time axis
(``GridLQT.S_T``/``v_T``) carry only the record dims.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

Tensor = torch.Tensor


class LQTElement(NamedTuple):
    """Conditional value function parameters, possibly with leading axes."""

    A: Tensor    # (..., nx, nx)
    b: Tensor    # (..., nx)
    C: Tensor    # (..., nx, nx), symmetric PSD
    eta: Tensor  # (..., nx)
    J: Tensor    # (..., nx, nx), symmetric PSD

    @property
    def nx(self) -> int:
        return self.A.shape[-1]

    def __len__(self) -> int:  # leading (scan) axis length
        return self.A.shape[0]


class AffineElement(NamedTuple):
    """Affine trajectory-recovery element (eqs. 45-46)."""

    Phi: Tensor   # (..., nx, nx)
    beta: Tensor  # (..., nx)

    def __len__(self) -> int:
        return self.Phi.shape[0]


class ValueFn(NamedTuple):
    """Quadratic value function 1/2 phi^T S phi - v^T phi (information form)."""

    S: Tensor  # (..., nx, nx)
    v: Tensor  # (..., nx)


class GridLQT(NamedTuple):
    """Time-reversed discretised LQT problem for the MAP estimate.

    Substep ``j`` covers reversed time ``[tau_j, tau_{j+1}]`` with step
    ``dt[j]``.  The terminal (reversed) boundary carries the prior:
    ``S_T = P0^{-1}``, ``v_T = P0^{-1} m0`` (below eq. 15).
    """

    dt: Tensor      # (N, *R)
    F: Tensor       # (N, *R, nx, nx)   F~(tau_j) = -F(t_f - tau_j)
    c: Tensor       # (N, *R, nx)
    H: Tensor       # (N, *R, ny, nx)
    r: Tensor       # (N, *R, ny)
    Q: Tensor       # (N, *R, nx, nx)
    Rinv: Tensor    # (N, *R, ny, ny)
    y: Tensor       # (N, *R, ny)
    S_T: Tensor     # (*R, nx, nx) terminal information matrix
    v_T: Tensor     # (*R, nx)     terminal information vector
    lin: Optional[Tensor] = None  # (N, *R, nx) optional extra linear cost

    @property
    def N(self) -> int:
        return self.F.shape[0]

    @property
    def nx(self) -> int:
        return self.F.shape[-1]

    @property
    def ny(self) -> int:
        return self.H.shape[-2]


class MAPSolution(NamedTuple):
    """Result of a MAP solve in ORIGINAL time order (time axis first).

    ``x`` has N+1 points (t_0 .. t_f inclusive); ``S``/``v`` are the
    information-form filter quantities at each t_k.
    """

    x: Tensor                      # (N+1, *R, nx)
    S: Tensor                      # (N+1, *R, nx, nx)
    v: Tensor                      # (N+1, *R, nx)
    cov: Optional[Tensor] = None   # (N+1, *R, nx, nx) smoothing covariance


@dataclasses.dataclass(frozen=True)
class Solution:
    """Result of :meth:`repro_torch.core.Estimator.solve`.

    Unlike :class:`MAPSolution`, fields follow the estimation surface's
    layout: stacked problems carry the record axis FIRST
    (``x`` ``(B, N+1, nx)``), single problems none.  ``cost`` is the
    discretised Onsager-Machlup cost of ``x``.
    """

    x: Tensor                       # (..., N+1, nx) MAP trajectory
    S: Tensor                       # (..., N+1, nx, nx) filter info
    v: Tensor                       # (..., N+1, nx)
    cov: Optional[Tensor] = None    # (..., N+1, nx, nx)
    cost: Optional[Tensor] = None   # (...,) Onsager-Machlup cost
