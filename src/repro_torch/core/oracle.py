"""Dense quadratic-program oracle for the discretised MAP problem.

The Euler-discretised (backward-Euler in original time, matching the
reversed-time solvers) Onsager-Machlup / minimum-energy functional is an
unconstrained convex quadratic in the stacked trajectory
``X = (x_0, ..., x_N)``:

    M(X) = 1/2 (x_0 - m_0)^T P_0^{-1} (x_0 - m_0)
         + sum_k dt/2 || (x_{k+1}-x_k)/dt - F_k x_{k+1} - c_k ||^2_{Q_k^{-1}}
         + sum_k dt/2 || y_k - H_k x_{k+1} - r_k ||^2_{R_k^{-1}}
         (+ sum_k dt lin_k . x_{k+1})

Building the dense Hessian and solving gives the EXACT discrete MAP
trajectory of one record -- the ground truth the scan-based solvers are
tested against (``discrete`` mode to round-off, ``euler`` mode to O(dt)).
Only meant for small N (tests): it is O((N nx)^3), in float64 numpy on the
host.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .sde import LinearSDE
from .types import GridLQT, Tensor


def qp_map_estimate(model: LinearSDE, ts: Tensor, y: Tensor,
                    lin: Optional[Tensor] = None) -> Tensor:
    """The exact discrete MAP trajectory ``(N+1, nx)`` of one record."""
    F, c, H, r, Q, R = model.grids(ts)
    dt = ts[1:] - ts[:-1]
    return _qp_solve(F, c, H, r, Q, R, y, dt, model.m0, model.P0, lin,
                     like=ts)


def qp_map_from_grid(grid: GridLQT) -> Tensor:
    """Solve the QP directly from a (reversed-time, single-record)
    GridLQT; returns the trajectory in ORIGINAL time order (N+1, nx)."""
    flip = lambda a: torch.flip(a, (0,))
    P0 = torch.linalg.inv(grid.S_T)
    m0 = P0 @ grid.v_T
    return _qp_solve(
        -flip(grid.F), -flip(grid.c), flip(grid.H), flip(grid.r),
        flip(grid.Q), torch.linalg.inv(flip(grid.Rinv)), flip(grid.y),
        flip(grid.dt), m0, P0, None if grid.lin is None else flip(grid.lin),
        like=grid.F)


def _qp_solve(F, c, H, r, Q, R, y, dt, m0, P0, lin=None, *, like):
    F, c, H, r, Q, R, y, dt, m0, P0 = (
        a.detach().cpu().numpy().astype(np.float64)
        for a in (F, c, H, r, Q, R, y, dt, m0, P0))
    if lin is not None:
        lin = lin.detach().cpu().numpy().astype(np.float64)
    N, nx = F.shape[0], F.shape[-1]
    n_tot = (N + 1) * nx
    Hmat = np.zeros((n_tot, n_tot))
    g = np.zeros((n_tot,))
    I = np.eye(nx)

    P0inv = np.linalg.inv(P0)
    Hmat[:nx, :nx] += P0inv
    g[:nx] += P0inv @ m0

    Qinv = np.linalg.inv(Q)
    Rinv = np.linalg.inv(R)
    for k in range(N):
        dtk = dt[k]
        # dynamics residual  D_k x_k + E_k x_{k+1} - c_k  with
        # D_k = -I/dt, E_k = I/dt - F_k (backward-Euler), weight dt * Qinv
        D = -I / dtk
        E = I / dtk - F[k]
        W = dtk * Qinv[k]
        sl0 = slice(k * nx, (k + 1) * nx)
        sl1 = slice((k + 1) * nx, (k + 2) * nx)
        Hmat[sl0, sl0] += D.T @ W @ D
        Hmat[sl0, sl1] += D.T @ W @ E
        Hmat[sl1, sl0] += E.T @ W @ D
        Hmat[sl1, sl1] += E.T @ W @ E
        g[sl0] += D.T @ W @ c[k]
        g[sl1] += E.T @ W @ c[k]
        # measurement  y_k ~ H_k x_{k+1} + r_k, weight dt * Rinv
        Wm = dtk * Rinv[k]
        Hmat[sl1, sl1] += H[k].T @ Wm @ H[k]
        g[sl1] += H[k].T @ Wm @ (y[k] - r[k])
        if lin is not None:
            g[sl1] += -dtk * lin[k]

    X = np.linalg.solve(Hmat, g)
    return torch.as_tensor(X.reshape(N + 1, nx), dtype=like.dtype,
                           device=like.device)
