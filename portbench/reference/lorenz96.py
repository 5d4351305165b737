"""Plain reference of the ``lorenz96`` configuration: Lorenz-96 (Lorenz &
Emanuel 1998, eq. 1) with N variables, forcing F and additive noise,
every other variable observed, in plain ``torch`` float64 (TF32 off),
with its Jacobian written by hand.

    f_i(x) = (x_{i+1} - x_{i-2}) x_{i-1} - x_i + F      (cyclic i)
    h(x)   = (x_0, x_2, ..., x_{N-2})

``simulate`` draws records by Euler-Maruyama (with a ``torch.Generator``,
on the card in a run); ``solve`` is the iterated extended smoother as the
program runs it: pass i linearises ``f`` at the previous pass's trajectory
at each interval's left point ``xbar_k`` (the first pass at the prior
mean), and a sequential covariance-form Kalman filter and
Rauch-Tung-Striebel smoother solve the linearised backward-Euler problem
of :mod:`kalman` (its docstring), batched over records, on the card when
there is one.  ``h`` is linear, so ``H`` is the selection of the observed
variables and ``r = 0``.  No element, no combine, no information form.

``tests/plain_lorenz96.py`` is the tier-1 tests' copy of the same
smoother; a benchmark test holds the two together.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch


def f(x: torch.Tensor, forcing: float) -> torch.Tensor:
    """The drift of states ``(..., N)``."""
    return ((torch.roll(x, -1, -1) - torch.roll(x, 2, -1))
            * torch.roll(x, 1, -1) - x + forcing)


def f_jacobian(x: torch.Tensor) -> torch.Tensor:
    """``df_i/dx_j`` of states ``(..., N)``: ``x_{i-1}`` at ``j = i + 1``,
    ``-x_{i-1}`` at ``i - 2``, ``x_{i+1} - x_{i-2}`` at ``i - 1``, ``-1``
    at ``i`` (N >= 4)."""
    n = x.shape[-1]
    i = torch.arange(n, device=x.device)
    J = torch.zeros(x.shape + (n,), dtype=x.dtype, device=x.device)
    J[..., i, (i + 1) % n] = torch.roll(x, 1, -1)
    J[..., i, (i - 2) % n] = -torch.roll(x, 1, -1)
    J[..., i, (i - 1) % n] = torch.roll(x, -1, -1) - torch.roll(x, 2, -1)
    J[..., i, i] = -1.0
    return J


def selection(n: int, **kw) -> torch.Tensor:
    """``H`` of ``h``: rows of the identity at the even variables."""
    return torch.eye(n, **kw)[0::2]


@contextlib.contextmanager
def _no_tf32():
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def _psd_sqrt(S: torch.Tensor) -> torch.Tensor:
    w, V = torch.linalg.eigh(S)
    return V * torch.sqrt(torch.clamp(w, min=0.0))


def iterated_smoother(y, m0, P0, Q, R, dt: float, forcing: float,
                      iterations: int) -> torch.Tensor:
    """Trajectories ``(B, steps + 1, N)`` of records ``y`` ``(B, steps,
    N / 2)`` after ``iterations`` passes; every argument a float64 tensor
    on one device (``m0`` ``(N,)``, the rest matrices)."""
    B, steps, n = y.shape[0], y.shape[1], m0.shape[-1]
    kw = dict(dtype=y.dtype, device=y.device)
    I = torch.eye(n, **kw)
    H = selection(n, **kw)
    Rd = R / dt
    ys = y.transpose(0, 1)                         # (steps, B, ny)
    xbar = m0.expand(steps + 1, B, n)
    for _ in range(iterations):
        xl = xbar[:-1]                             # (steps, B, N): xbar_k
        F = f_jacobian(xl)
        c = f(xl, forcing) - (F @ xl[..., None])[..., 0]
        M = torch.linalg.inv(I - dt * F)
        d = (M @ (dt * c)[..., None])[..., 0]
        Qd = M @ (dt * Q) @ M.mT
        # the filter's covariances and gains (Joseph form)
        P = P0.expand(B, n, n)
        K = torch.empty((steps, B, n, H.shape[0]), **kw)
        Pf = torch.empty((steps, B, n, n), **kw)       # of x_k
        Pp = torch.empty((steps, B, n, n), **kw)       # predicted, of x_{k+1}
        for k in range(steps):
            pred = M[k] @ P @ M[k].mT + Qd[k]
            PHt = pred @ H.mT
            Kk = torch.linalg.solve(H @ PHt + Rd, PHt.mT).mT
            IKH = I - Kk @ H
            Pf[k], Pp[k], K[k] = P, pred, Kk
            P = IKH @ pred @ IKH.mT + Kk @ Rd @ Kk.mT
        G = torch.linalg.solve(Pp, M @ Pf).mT          # P M^T Pp^-1
        # the means: filter forward, smoother backward
        A = I - K @ H
        Phi = A @ M
        drive = (A @ d[..., None])[..., 0] + (K @ ys[..., None])[..., 0]
        mf = torch.empty((steps + 1, B, n), **kw)
        mf[0] = m0
        for k in range(steps):
            mf[k + 1] = (Phi[k] @ mf[k][..., None])[..., 0] + drive[k]
        mp = (M @ mf[:-1][..., None])[..., 0] + d
        e = mf[:-1] - (G @ mp[..., None])[..., 0]
        x = torch.empty((steps + 1, B, n), **kw)
        x[steps] = s = mf[steps]
        for k in range(steps - 1, -1, -1):
            x[k] = s = (G[k] @ s[..., None])[..., 0] + e[k]
        xbar = x
    return xbar.transpose(0, 1)


def _matrices(cfg: dict, **kw) -> dict:
    return {k: torch.tensor(cfg[k], **kw) for k in ("Q", "R", "m0", "P0")}


def simulate(cfg: dict, lengths, gen: torch.Generator) -> np.ndarray:
    """Measurements ``(B, max(lengths), N / 2)`` (host float64) by
    Euler-Maruyama from ``x_0 ~ N(m0, P0)``, drawn from ``gen`` on its
    device; ``y_k`` observes ``x_{k+1}`` with noise ``N(0, R / dt)``."""
    kw = dict(dtype=torch.float64, device=gen.device)
    m = _matrices(cfg, **kw)
    dt, forcing = float(cfg["dt"]), float(cfg["forcing"])
    B, steps, n = len(lengths), int(max(lengths)), m["m0"].shape[0]
    with _no_tf32():
        sq_q, sq_r = _psd_sqrt(m["Q"] * dt), _psd_sqrt(m["R"] / dt)
        x = m["m0"] + torch.randn((B, n), generator=gen, **kw) @ _psd_sqrt(
            m["P0"]).T
        eps = torch.randn((steps, B, n), generator=gen, **kw) @ sq_q.T
        noise = torch.randn((steps, B, n // 2), generator=gen, **kw) @ sq_r.T
        y = torch.empty((steps, B, n // 2), **kw)
        for k in range(steps):
            x = x + dt * f(x, forcing) + eps[k]
            y[k] = x[:, 0::2] + noise[k]
    return y.transpose(0, 1).cpu().numpy()


def solve(cfg: dict, y: np.ndarray, lengths) -> np.ndarray:
    """Reference trajectories ``(B, steps + 1, N)`` after ``iterations``
    passes, on the card when there is one.  Every record must be
    ``steps`` long (the linearisation is per record and step)."""
    if np.any(np.asarray(lengths) != y.shape[1]):
        raise ValueError("lorenz96 reference takes records of one length")
    device = "cuda" if torch.cuda.is_available() else "cpu"
    kw = dict(dtype=torch.float64, device=device)
    m = _matrices(cfg, **kw)
    with _no_tf32():
        x = iterated_smoother(torch.tensor(y, **kw), m["m0"], m["P0"],
                              m["Q"], m["R"], float(cfg["dt"]),
                              float(cfg["forcing"]), int(cfg["iterations"]))
    return x.cpu().numpy()
