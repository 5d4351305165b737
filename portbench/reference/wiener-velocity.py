"""Plain reference of the ``wiener-velocity`` configuration: a linear
time-invariant model given by its matrices (``F, c, H, r, Q, R, m0, P0``)
on a grid of constant step ``dt``.

``simulate`` draws records by the exact discretisation of the SDE (Van
Loan's matrix exponential), summed in closed form over time, with a
``torch.Generator`` (on the card in a run); ``solve`` is the sequential smoother of
:mod:`kalman` on the backward-Euler problem that the program solves.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.linalg import expm

from portbench.reference import kalman


def matrices(cfg: dict) -> dict:
    return {k: np.asarray(cfg[k], dtype=np.float64)
            for k in ("F", "c", "H", "r", "Q", "R", "m0", "P0")}


def _psd_sqrt(S: np.ndarray) -> np.ndarray:
    w, V = np.linalg.eigh(S)
    return V * np.sqrt(np.clip(w, 0.0, None))


def exact_step(F, c, Q, dt):
    """``(Phi, u, Qd)``: ``x(t + dt) = Phi x(t) + u + N(0, Qd)`` exactly
    (Van Loan)."""
    nx = F.shape[0]
    Z = np.zeros((2 * nx, 2 * nx))
    Z[:nx, :nx] = -F
    Z[:nx, nx:2 * nx] = Q
    Z[nx:2 * nx, nx:2 * nx] = F.T
    E = expm(Z * dt)
    Phi = E[nx:2 * nx, nx:2 * nx].T
    Qd = Phi @ E[:nx, nx:2 * nx]
    A = np.zeros((nx + 1, nx + 1))
    A[:nx, :nx], A[:nx, nx] = F, c
    u = expm(A * dt)[:nx, nx]
    return Phi, u, 0.5 * (Qd + Qd.T)


def simulate(cfg: dict, lengths, gen: torch.Generator,
             chunk: int = 64) -> np.ndarray:
    """Measurements ``(B, max(lengths), ny)`` (host float64) of
    ``len(lengths)`` records from ``x_0 ~ N(m0, P0)``, drawn from ``gen``
    on its device; record ``i`` uses its first ``lengths[i]`` rows.
    ``y_k`` measures ``x_{k+1}`` with noise ``N(0, R / dt)``.

    ``F`` is nilpotent (``F^2 = 0``: positions integrate velocities), so
    ``x_{k+1} = x_k + dt F x_k + w_k`` with ``w_k = u + e_k`` sums in
    closed form: ``x_k = x_0 + k dt F x_0 + W_k + dt F sum_{j<k} W_j``,
    ``W_k = sum_{i<k} w_i``.  Records are drawn ``chunk`` at a time."""
    m = matrices(cfg)
    if np.any(m["F"] @ m["F"]):
        raise ValueError("this simulator needs F @ F == 0")
    dt = float(cfg["dt"])
    B, steps = len(lengths), int(max(lengths))
    _, u, Qd = exact_step(m["F"], m["c"], m["Q"], dt)
    kw = dict(dtype=torch.float64, device=gen.device)
    T = lambda a: torch.as_tensor(a, **kw)
    F, H, r, u = T(m["F"]), T(m["H"]), T(m["r"]), T(u)
    sq_q, sq_r = T(_psd_sqrt(Qd)), T(_psd_sqrt(m["R"] / dt))
    sq_p, m0 = T(_psd_sqrt(m["P0"])), T(m["m0"])
    nx, ny = F.shape[0], H.shape[0]
    k = dt * torch.arange(1, steps + 1, **kw)[:, None]

    def randn(*shape):
        return torch.randn(shape, generator=gen, **kw)

    y = np.empty((B, steps, ny))
    for lo in range(0, B, chunk):
        b = min(chunk, B - lo)
        x0 = m0 + randn(b, nx) @ sq_p.T
        W = torch.cumsum(u + randn(b, steps, nx) @ sq_q.T, dim=1)
        V = torch.cumsum(W, dim=1) - W            # sum_{j<=k} W_j, W_0 = 0
        x = x0[:, None] + k * (x0 @ F.T)[:, None] + W + dt * (V @ F.T)
        y[lo:lo + b] = (x @ H.T + r
                        + randn(b, steps, ny) @ sq_r.T).cpu().numpy()
    return y


def solve(cfg: dict, y: np.ndarray, lengths) -> np.ndarray:
    """Reference MAP trajectories ``(B, steps + 1, nx)`` of records ``y``;
    row ``i`` is valid up to point ``lengths[i]``."""
    m = matrices(cfg)
    dt = float(cfg["dt"])
    M, d, Qd = kalman.forward_model(m["F"], m["c"], m["Q"], dt)
    return kalman.smooth(M, d, Qd, m["H"], m["r"], m["R"] / dt, y, lengths,
                         m["m0"], m["P0"])
