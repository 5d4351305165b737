"""The plain reference solve: the discretised MAP problem by a sequential
Kalman filter and Rauch-Tung-Striebel smoother in covariance form, in
float64 NumPy.

The problem (original time, intervals k = 0..N-1 of length dt_k) is the
one the port's ``discrete`` element mode solves exactly:

    x_0 ~ N(m0, P0)
    x_k = (I - dt_k F_k) x_{k+1} - dt_k c_k + w_k,   w_k ~ N(0, dt_k Q_k)
    y_k = H_k x_{k+1} + r_k + v_k,                  v_k ~ N(0, R_k / dt_k)

(backward Euler: the drift and the measurement of interval k are taken at
its right point).  With ``M_k = (I - dt_k F_k)^-1`` it is the ordinary
forward model ``x_{k+1} = M_k x_k + M_k dt_k c_k + u_k``, ``u_k ~ N(0,
M_k dt_k Q_k M_k^T)``, whose posterior mean the filter and smoother give.
Q may be singular (the Wiener model drives only the velocities).

Nothing here is shared with the program under test: no element, no
combine, no information form, no padding.  A record of N intervals is
solved on its own N intervals.
"""
from __future__ import annotations

import numpy as np


def _mT(a: np.ndarray) -> np.ndarray:
    return np.swapaxes(a, -1, -2)


def _mv(A: np.ndarray, x: np.ndarray) -> np.ndarray:
    return (A @ x[..., None])[..., 0]


def _inv(S: np.ndarray) -> np.ndarray:
    """Inverse of the (batched) innovation covariance; 1 x 1 and 2 x 2 in
    closed form (one call to LAPACK per matrix costs more than the
    filter step)."""
    n = S.shape[-1]
    if n == 1:
        return 1.0 / S
    if n == 2:
        a, b, c, d = S[..., 0, 0], S[..., 0, 1], S[..., 1, 0], S[..., 1, 1]
        det = a * d - b * c
        return np.stack([np.stack([d, -b], -1), np.stack([-c, a], -1)],
                        -2) / det[..., None, None]
    return np.linalg.inv(S)


def forward_model(F, c, Q, dt):
    """``(M, d, Qd)`` of the forward model from the backward-Euler step.

    ``F`` ``(..., nx, nx)``, ``c`` ``(..., nx)``, ``Q`` ``(..., nx, nx)``
    and ``dt`` ``(...)`` broadcast against each other."""
    nx = F.shape[-1]
    dt = np.asarray(dt, dtype=np.float64)
    M = np.linalg.inv(np.eye(nx) - dt[..., None, None] * F)
    d = _mv(M, dt[..., None] * c)
    Qd = M @ (dt[..., None, None] * Q) @ _mT(M)
    return M, d, Qd


def gains(M, Qd, H, Rd, P0, steps: int):
    """Kalman and smoother gains of ``steps`` steps from the prior
    covariance ``P0``.

    ``M``, ``Qd``, ``H``, ``Rd`` are either one matrix each (a
    time-invariant model: the covariances do not depend on the data, so
    every record that starts from ``P0`` shares them) or ``(steps, *B,
    ...)`` per step and record.  Returns ``K`` ``(n, *B, nx, ny)`` and
    ``G`` ``(n, *B, nx, nx)`` with ``n <= steps``: ``K[k]`` updates the
    prediction of ``x_{k+1}`` with ``y_k``, ``G[k]`` smooths ``x_k`` from
    ``x_{k+1}``.  A time-invariant model stops once the filtered
    covariance repeats bit for bit: from there on every step computes the
    same numbers, so step ``k >= n`` takes ``K[n-1]``, ``G[n-1]``.
    """
    shared = M.ndim == 2

    def at(a, k):
        return a if shared else a[k]

    P = P0 if shared else np.broadcast_to(P0, M.shape[1:]).copy()
    I = np.eye(P.shape[-1])
    K = np.empty((steps,) + P.shape[:-2] + (P.shape[-1], H.shape[-2]))
    Pf = np.empty((steps,) + P.shape)             # filtered, of x_k
    Pp = np.empty((steps,) + P.shape)             # predicted, of x_{k+1}
    n = steps
    for k in range(steps):
        Mk, Hk, Rk = at(M, k), at(H, k), at(Rd, k)
        pred = Mk @ P @ _mT(Mk) + at(Qd, k)
        PHt = pred @ _mT(Hk)
        Kk = PHt @ _inv(Hk @ PHt + Rk)
        IKH = I - Kk @ Hk
        # Joseph form: stays symmetric and positive definite
        new = IKH @ pred @ _mT(IKH) + Kk @ Rk @ _mT(Kk)
        K[k], Pf[k], Pp[k] = Kk, P, pred
        if shared and np.array_equal(new, P):
            n = k + 1
            break
        P = new
    Pf, Pp, Ms = Pf[:n], Pp[:n], (M if shared else M[:n])
    G = _mT(np.linalg.solve(Pp, Ms @ Pf))         # P M^T Pp^-1, Pp symmetric
    return K[:n], G


def smooth(M, d, Qd, H, r, Rd, y, lengths, m0, P0):
    """Posterior means of records ``y`` ``(B, steps, ny)`` (record ``i``
    uses its first ``lengths[i]`` measurements; the rest is ignored).

    The model arrays are one matrix or vector each (time-invariant, shared
    by every record) or ``(steps, B, ...)`` per step and record.  Returns
    ``x`` ``(B, steps + 1, nx)``; row ``i`` is valid up to ``lengths[i]``.

    With the gains known, each pass is an affine recursion: the filter
    ``m_{k+1} = (I - K_k H_k)(M_k m_k + d_k) + K_k (y_k - r_k)`` and the
    smoother ``s_k = m_k + G_k (s_{k+1} - M_k m_k - d_k)``; their
    data-independent parts are formed for all steps at once.
    """
    B, steps = y.shape[0], y.shape[1]
    lengths = np.asarray(lengths)
    shared = M.ndim == 2
    K, G = gains(M, Qd, H, Rd, P0, steps)
    idx = np.minimum(np.arange(steps), K.shape[0] - 1)
    K, G = K[idx], G[idx]                         # one gain per step
    nx = m0.shape[-1]
    I = np.eye(nx)
    ys = np.swapaxes(y, 0, 1)                     # (steps, B, ny)
    mf = np.empty((steps + 1, B, nx))             # filtered means
    mf[0] = m0
    if shared:                                    # rows (B, nx) times M^T
        A = I - K @ H                             # (steps, nx, nx)
        Phi = np.swapaxes(A @ M, -1, -2)
        drive = ((d @ np.swapaxes(A, -1, -2))[:, None]
                 + (ys - r) @ np.swapaxes(K, -1, -2))
        for k in range(steps):
            mf[k + 1] = mf[k] @ Phi[k] + drive[k]
        mp = mf[:-1] @ M.T + d
        Gt = np.swapaxes(G, -1, -2)
        e = mf[:-1] - mp @ Gt
        step = lambda k, s: s @ Gt[k] + e[k]
    else:
        A = I - K @ H                             # (steps, B, nx, nx)
        Phi = A @ M
        drive = _mv(A, d) + _mv(K, ys - r)
        for k in range(steps):
            mf[k + 1] = _mv(Phi[k], mf[k]) + drive[k]
        mp = _mv(M, mf[:-1]) + d
        e = mf[:-1] - _mv(G, mp)
        step = lambda k, s: _mv(G[k], s) + e[k]
    ragged = bool(np.any(lengths != steps))
    active = np.arange(steps)[:, None] < lengths  # (steps, B)
    out = np.empty((steps + 1, B, nx))
    out[steps] = s = mf[steps]
    for k in range(steps - 1, -1, -1):
        s = step(k, s)
        if ragged:
            # a record of N intervals starts its backward pass at x_N
            s = np.where(active[k][:, None], s, mf[k])
        out[k] = s
    return np.swapaxes(out, 0, 1)
