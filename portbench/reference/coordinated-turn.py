"""Plain reference of the ``coordinated-turn`` configuration: the
coordinated-turn model with range and bearing measurements (arXiv
2512.13319, eqs. 55-58), written out with its Jacobians by hand.

    f(x) = (x2, x3, -x4 x3, x4 x2, 0)
    h(x) = (sqrt(x0^2 + x1^2), atan2(x1, x0))

``simulate`` draws records by Euler-Maruyama (with a ``torch.Generator``,
on the card in a run); ``solve`` is the iterated
extended smoother as the program runs it: pass i linearises ``f`` and
``h`` at the previous pass's trajectory at each interval's left point
``xbar_k`` (the first pass at the prior mean), and the sequential smoother
of :mod:`kalman` solves the linearised backward-Euler problem.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import kalman


def matrices(cfg: dict) -> dict:
    return {k: np.asarray(cfg[k], dtype=np.float64)
            for k in ("Q", "R", "m0", "P0")}


def f(x):
    """The drift, of NumPy arrays or torch tensors ``(..., 5)``."""
    xp = torch if isinstance(x, torch.Tensor) else np
    return xp.stack([x[..., 2], x[..., 3], -x[..., 4] * x[..., 3],
                     x[..., 4] * x[..., 2], 0.0 * x[..., 4]], -1)


def f_jacobian(x: np.ndarray) -> np.ndarray:
    J = np.zeros(x.shape + (5,))
    J[..., 0, 2] = 1.0
    J[..., 1, 3] = 1.0
    J[..., 2, 3] = -x[..., 4]
    J[..., 2, 4] = -x[..., 3]
    J[..., 3, 2] = x[..., 4]
    J[..., 3, 4] = x[..., 2]
    return J


def h(x):
    """Range and bearing, of NumPy arrays or torch tensors ``(..., 5)``."""
    if isinstance(x, torch.Tensor):
        return torch.stack([torch.hypot(x[..., 0], x[..., 1]),
                            torch.atan2(x[..., 1], x[..., 0])], -1)
    return np.stack([np.hypot(x[..., 0], x[..., 1]),
                     np.arctan2(x[..., 1], x[..., 0])], -1)


def h_jacobian(x: np.ndarray) -> np.ndarray:
    p, q = x[..., 0], x[..., 1]
    rho2 = p * p + q * q
    rho = np.sqrt(rho2)
    J = np.zeros(x.shape[:-1] + (2, 5))
    J[..., 0, 0], J[..., 0, 1] = p / rho, q / rho
    J[..., 1, 0], J[..., 1, 1] = -q / rho2, p / rho2
    return J


def _psd_sqrt(S: np.ndarray) -> np.ndarray:
    w, V = np.linalg.eigh(S)
    return V * np.sqrt(np.clip(w, 0.0, None))


def simulate(cfg: dict, lengths, gen: torch.Generator) -> np.ndarray:
    """Measurements ``(B, max(lengths), 2)`` (host float64) by
    Euler-Maruyama from ``x_0 ~ N(m0, P0)``, drawn from ``gen`` on its
    device; ``y_k`` measures ``x_{k+1}`` with noise ``N(0, R / dt)``."""
    m = matrices(cfg)
    dt = float(cfg["dt"])
    B, steps = len(lengths), int(max(lengths))
    kw = dict(dtype=torch.float64, device=gen.device)
    T = lambda a: torch.as_tensor(a, **kw)
    sq_q, sq_r = T(_psd_sqrt(m["Q"] * dt)), T(_psd_sqrt(m["R"] / dt))
    x = T(m["m0"]) + torch.randn((B, 5), generator=gen, **kw) @ T(
        _psd_sqrt(m["P0"])).T
    eps = torch.randn((steps, B, 5), generator=gen, **kw) @ sq_q.T
    noise = torch.randn((steps, B, 2), generator=gen, **kw) @ sq_r.T
    y = torch.empty((steps, B, 2), **kw)
    for k in range(steps):
        x = x + dt * f(x) + eps[k]
        y[k] = h(x) + noise[k]
    return y.transpose(0, 1).cpu().numpy()


def solve(cfg: dict, y: np.ndarray, lengths) -> np.ndarray:
    """Reference trajectories ``(B, steps + 1, 5)`` after ``iterations``
    passes.  Every record must be ``steps`` long (the linearisation is per
    record and step, so nothing is shared to exploit)."""
    if np.any(np.asarray(lengths) != y.shape[1]):
        raise ValueError("coordinated-turn reference takes records of one "
                         "length")
    m = matrices(cfg)
    dt = float(cfg["dt"])
    B, steps = y.shape[0], y.shape[1]
    xbar = np.broadcast_to(m["m0"], (B, steps + 1, 5))
    Rd = np.broadcast_to(m["R"] / dt, (steps, B, 2, 2))
    for _ in range(int(cfg["iterations"])):
        xl = np.swapaxes(xbar[:, :-1], 0, 1)       # (steps, B, 5): xbar_k
        F = f_jacobian(xl)
        c = f(xl) - kalman._mv(F, xl)
        H = h_jacobian(xl)
        r = h(xl) - kalman._mv(H, xl)
        M, d, Qd = kalman.forward_model(F, c, m["Q"], np.full(F.shape[:2], dt))
        xbar = kalman.smooth(M, d, Qd, H, r, Rd, y, lengths, m["m0"],
                             m["P0"])
    return xbar
