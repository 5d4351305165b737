"""Continuous-time state-space models (linear eq. 12 and nonlinear eq. 1),
grid discretisation, simulation and the discretised Onsager-Machlup cost
(eq. 2).

Grid conventions (as in the reference package):

* original time grid ``t_k = t0 + k dt`` for ``k = 0..N``; coefficient /
  measurement index ``k`` covers ``[t_k, t_{k+1}]``;
* the reversed problem has ``phi_j = x(t_{N-j})``; reversed interval ``j``
  maps to original interval ``k = N-1-j`` and evaluates the drift at the
  reversed-left point ``phi_j = x_{k+1}`` (backward-Euler in original time);
* measurement noise with spectral density R discretises to
  ``y_k ~ N(h(x), R/dt)``.

Record batches: a time grid ``ts`` of shape ``(N+1, *R)`` evaluates every
coefficient to ``(N, *R, ...)`` (see :mod:`repro_torch.core.types`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import torch

from repro_torch.linearize import get_linearization
from repro_torch.linearize.base import vmap_points
from repro_torch.linearize.taylor import taylor_linearize_grid

from .combine import _mv, _solve_vec
from .types import GridLQT, Tensor

Array = Tensor
Coef = Union[Tensor, Callable[[Tensor], Tensor]]

# Information-form prior override (S0, v0): the initial boundary enters the
# reversed LQT as terminal information S_T = S0, v_T = v0.
Prior = Tuple[Tensor, Tensor]

# cuSOLVER's batched eigh (cusolverDnXsyevBatched, CUDA 12.8, an H100)
# refuses more than 23325 to 32016 matrices in one call (n = 32 down to 2),
# so _psd_sqrt runs its eigendecompositions in chunks of at most this many;
# chip_smoke.py probes the limit and holds the constant below it.
# cholesky, inv and pinv take a grid of 1.31 M matrices whole.  A constant
# noise matrix is factored once and broadcast (_factor_once; the
# estimator's OM cost takes one pseudo-inverse of a constant Q): only a
# callable one is factored on every grid point.
EIGH_CHUNK = 16384


class _Model:
    """What the linear and nonlinear models share: sizes, dtype, device
    moves and grid evaluation of a coefficient."""

    @property
    def nx(self) -> int:
        return self.m0.shape[-1]

    @property
    def ny(self) -> Optional[int]:
        """Measurement dimension, or ``None`` when ``R`` is a callable."""
        return None if callable(self.R) else self.R.shape[-1]

    @property
    def dtype(self) -> torch.dtype:
        return self.m0.dtype

    def to(self, device=None, dtype=None):
        """Copy with every constant tensor moved/cast (callables are kept)."""
        def move(a):
            return a if callable(a) else a.to(device=device, dtype=dtype)

        return type(self)(*(move(getattr(self, f.name))
                            for f in dataclasses.fields(self)))

    @staticmethod
    def _eval(item: Coef, tl: Tensor) -> Tensor:
        if callable(item):
            out = torch.func.vmap(item)(tl.reshape(-1))
            return out.reshape(tl.shape + out.shape[1:])
        return item.expand(tl.shape + item.shape)


@dataclasses.dataclass(frozen=True)
class LinearSDE(_Model):
    """Linear-affine model (eq. 12), possibly time-varying via callables.

    ``F, c, H, r, Q, R`` are each a constant tensor or a callable of a
    scalar time tensor (evaluated on the grid with ``torch.func.vmap``; it
    must return tensors on the device and dtype of its argument).
    """

    F: Coef
    c: Coef
    H: Coef
    r: Coef
    Q: Coef
    R: Coef
    m0: Tensor
    P0: Tensor

    def grids(self, ts: Tensor):
        """All coefficients on the left points of the N intervals."""
        tl = ts[:-1]
        return tuple(self._eval(a, tl)
                     for a in (self.F, self.c, self.H, self.r, self.Q, self.R))


@dataclasses.dataclass(frozen=True)
class NonlinearSDE(_Model):
    """Nonlinear model (eq. 1): drift ``f(x, t)``, observation ``h(x, t)``.

    ``f`` and ``h`` are torch functions of one state ``x`` ``(nx,)`` and a
    scalar time tensor ``t`` that ``torch.func.vmap`` and
    ``torch.func.jacfwd`` can transform (no in-place writes, no
    ``.item()``); grids evaluate them at every point in one ``vmap``.
    ``Q``/``R`` are constant tensors or callables of t, as in
    :class:`LinearSDE`.
    """

    f: Callable[[Tensor, Tensor], Tensor]
    h: Callable[[Tensor, Tensor], Tensor]
    Q: Coef
    R: Coef
    m0: Tensor
    P0: Tensor

    def linearise(self, xbar: Tensor, ts: Tensor):
        """First-order Taylor expansion about a nominal trajectory
        ``xbar`` ``(N+1, *R, nx)``: grid tensors (F, c, H, r) with
        ``f ~= F x + c`` and ``h ~= H x + r`` at each interval left point
        (section 4.4)."""
        tl, xb = ts[:-1], xbar[:-1]
        F, c = taylor_linearize_grid(self.f, xb, tl)
        H, r = taylor_linearize_grid(self.h, xb, tl)
        return F, c, H, r

    def divergence_gradient(self, xbar: Tensor, ts: Tensor) -> Tensor:
        """grad_x (div f)(xbar, t) at the interval left points: the
        linearised Onsager-Machlup divergence correction."""
        return vmap_points(torch.func.grad(self._div_f), xbar[:-1], ts[:-1])

    def _div_f(self, x: Tensor, t: Tensor) -> Tensor:
        return torch.trace(torch.func.jacfwd(self.f)(x, t))


def time_grid(t0: float, tf: float, num_steps: int,
              dtype: torch.dtype = torch.float64, device=None) -> Tensor:
    return torch.linspace(t0, tf, num_steps + 1, dtype=dtype, device=device)


def build_grid_lqt(
    F: Tensor, c: Tensor, H: Tensor, r: Tensor, Q: Tensor, R: Tensor,
    y: Tensor, dt: Tensor, m0: Tensor, P0: Tensor,
    lin: Optional[Tensor] = None,
    measurement_mask: Optional[Tensor] = None,
    prior: Optional[Prior] = None,
) -> GridLQT:
    """Time-reverse grid coefficients into the LQT problem of section 2.4.

    Reversed interval ``j`` <- original interval ``N-1-j``; ``F~ = -F``,
    ``c~ = -c``.  ``measurement_mask`` (``(N, *R)``, original time order,
    1.0 = real) zeroes ``R^{-1}`` (and the optional linear cost) on masked
    intervals.  ``prior`` ``(S0, v0)`` replaces the covariance-form
    ``(m0, P0)`` boundary with information-form terminal values.
    """
    flip = lambda a: torch.flip(a, (0,))
    Rinv = torch.linalg.inv(R)
    if measurement_mask is not None:
        Rinv = Rinv * measurement_mask[..., None, None]
        if lin is not None:
            lin = lin * measurement_mask[..., None]
    if prior is not None:
        S_T, v_T = prior
    else:
        S_T = torch.linalg.inv(P0)
        v_T = _mv(S_T, m0)
    return GridLQT(
        dt=flip(dt.expand(y.shape[:-1])),
        F=-flip(F), c=-flip(c),
        H=flip(H), r=flip(r),
        Q=flip(Q), Rinv=flip(Rinv), y=flip(y),
        S_T=S_T, v_T=v_T,
        lin=None if lin is None else flip(lin),
    )


def grid_lqt_from_linear(
    model: LinearSDE, ts: Tensor, y: Tensor,
    measurement_mask: Optional[Tensor] = None,
    prior: Optional[Prior] = None,
) -> GridLQT:
    """``ts`` ``(N+1, *R)`` and ``y`` ``(N, *R, ny)`` share record dims."""
    if ts.shape[1:] != y.shape[1:-1]:
        raise ValueError(
            f"ts {tuple(ts.shape)} and y {tuple(y.shape)} must share the "
            f"record dims after the time axis")
    F, c, H, r, Q, R = model.grids(ts)
    dt = ts[1:] - ts[:-1]
    return build_grid_lqt(F, c, H, r, Q, R, y, dt, model.m0, model.P0,
                          measurement_mask=measurement_mask, prior=prior)


def grid_lqt_from_nonlinear(
    model: NonlinearSDE, ts: Tensor, y: Tensor, xbar: Tensor,
    divergence_correction: bool = False,
    measurement_mask: Optional[Tensor] = None,
    prior: Optional[Prior] = None,
    linearization=None,
) -> GridLQT:
    """Linearise the nonlinear model about ``xbar`` ``(N+1, *R, nx)`` and
    time-reverse into the grid LQT problem.

    ``linearization`` selects the strategy (``None``/"taylor" = the
    Jacobian path).  Strategies with a residual covariance (sigma-point
    SLR) fold it into the noise per grid point, ``Q + Omega_f`` and
    ``R + Omega_h``: the posterior-linearisation construction.  Their
    spread covariance is the model's ``P0`` (scaled by the strategy's
    ``spread``) at every point, a fixed proxy until posterior covariances
    are plumbed through; being shared, it is factored once.
    """
    if ts.shape[1:] != y.shape[1:-1]:
        raise ValueError(
            f"ts {tuple(ts.shape)} and y {tuple(y.shape)} must share the "
            f"record dims after the time axis")
    strategy = get_linearization(linearization)
    tl = ts[:-1]
    Q = model._eval(model.Q, tl)
    R = model._eval(model.R, tl)
    if not strategy.has_residual:
        F, c, H, r = model.linearise(xbar, ts)
    else:
        xb = xbar[:-1]
        F, c, Of = strategy.linearize_grid(model.f, xb, tl, model.P0)
        H, r, Oh = strategy.linearize_grid(model.h, xb, tl, model.P0)
        Q = Q + Of
        R = R + Oh
    dt = ts[1:] - ts[:-1]
    lin = None
    if divergence_correction:
        # Onsager-Machlup adds +1/2 int div f dt; linearised about xbar the
        # phi-dependent part is  1/2 g(xbar)^T phi with g = grad div f.
        lin = 0.5 * model.divergence_gradient(xbar, ts)
    return build_grid_lqt(F, c, H, r, Q, R, y, dt, model.m0, model.P0,
                          lin=lin, measurement_mask=measurement_mask,
                          prior=prior)


# ---------------------------------------------------------------------------
# Simulation + cost functional
# ---------------------------------------------------------------------------


def _psd_sqrt(Q: Tensor) -> Tensor:
    """Square root of a (possibly singular) PSD matrix via eigh, one
    matrix at a time, over the leading dims in calls of at most
    ``EIGH_CHUNK`` matrices.

    Eigenvalues within round-off of zero (up to ``10 n eps`` of the
    largest, the cutoff of :func:`om_cost_grid`'s pseudo-inverse) count as
    zero: eigh returns a singular Q's null eigenvalues as round-off (~1e-15
    of the largest), and their square roots would put ~1e-8 of the factor
    into directions Q does not drive."""
    flat = Q.reshape((-1,) + Q.shape[-2:])
    w, V = (torch.cat(parts) for parts in zip(
        *(torch.linalg.eigh(part) for part in flat.split(EIGH_CHUNK))))
    cut = (10.0 * Q.shape[-1] * torch.finfo(Q.dtype).eps
           * w.abs().amax(-1, keepdim=True))
    w = torch.where(w > cut, w, torch.zeros_like(w))
    return ((V * torch.sqrt(w).unsqueeze(-2)) @ V.mT).reshape(Q.shape)


def _factor_once(item: Coef, grid: Tensor, factor) -> Tensor:
    """``factor`` of a noise matrix on the grid: a constant one is factored
    once and broadcast, a callable one on every grid point."""
    if callable(item):
        return factor(grid)
    return factor(item).expand(grid.shape)


def simulate_linear(model: LinearSDE, ts: Tensor,
                    generator: torch.Generator):
    """Euler-Maruyama simulation of (12) + discretised measurements.

    ``ts`` ``(N+1, *R)`` simulates one record per entry of ``*R``; returns
    ``xs`` ``(N+1, *R, nx)`` and ``y`` ``(N, *R, ny)``.  Draws come from
    ``generator``, which must live on ``ts``'s device.
    """
    F, c, H, r, Q, R = model.grids(ts)
    dt = ts[1:] - ts[:-1]
    N, lead = dt.shape[0], tuple(ts.shape[1:])
    kw = dict(generator=generator, dtype=model.dtype, device=ts.device)
    x = model.m0 + _mv(torch.linalg.cholesky(model.P0),
                       torch.randn(lead + (model.nx,), **kw))
    eps = torch.randn((N,) + lead + (model.nx,), **kw)
    # the noise increments do not depend on the state: draw them in bulk.
    # A constant Q / R is factored once; a time-varying Q's square roots
    # run in chunks of EIGH_CHUNK (the GPU solver's batch limit).
    w = torch.sqrt(dt)[..., None] * _mv(_factor_once(model.Q, Q, _psd_sqrt),
                                        eps)
    dtv = dt[..., None]
    xs = [x]
    for k in range(N):
        x = x + dtv[k] * (_mv(F[k], x) + c[k]) + w[k]
        xs.append(x)
    xs = torch.stack(xs, dim=0)
    noise = torch.randn(H.shape[:-1], **kw)
    # measurement for interval k uses the reversed-left point x_{k+1}
    Rch = _factor_once(model.R, R, torch.linalg.cholesky)
    y = _mv(H, xs[1:]) + r + _mv(Rch, noise) / torch.sqrt(dtv)
    return xs, y


def simulate_nonlinear(model: NonlinearSDE, ts: Tensor,
                       generator: torch.Generator):
    """Euler-Maruyama simulation of (1) + discretised measurements.

    ``ts`` ``(N+1, *R)`` simulates one record per entry of ``*R``; returns
    ``xs`` ``(N+1, *R, nx)`` and ``y`` ``(N, *R, ny)``.  Draws come from
    ``generator``, which must live on ``ts``'s device; the drift is
    evaluated for all records at once at each step.
    """
    dt = ts[1:] - ts[:-1]
    tl = ts[:-1]
    Q = model._eval(model.Q, tl)
    R = model._eval(model.R, tl)
    N, lead = dt.shape[0], tuple(ts.shape[1:])
    kw = dict(generator=generator, dtype=model.dtype, device=ts.device)
    x = model.m0 + _mv(torch.linalg.cholesky(model.P0),
                       torch.randn(lead + (model.nx,), **kw))
    eps = torch.randn((N,) + lead + (model.nx,), **kw)
    w = torch.sqrt(dt)[..., None] * _mv(
        _factor_once(model.Q, Q, _psd_sqrt), eps)
    dtv = dt[..., None]
    xs = [x]
    for k in range(N):
        x = x + dtv[k] * vmap_points(model.f, x, tl[k]) + w[k]
        xs.append(x)
    xs = torch.stack(xs, dim=0)
    hx = vmap_points(model.h, xs[1:], tl)
    noise = torch.randn(hx.shape, **kw)
    Rch = _factor_once(model.R, R, torch.linalg.cholesky)
    y = hx + _mv(Rch, noise) / torch.sqrt(dtv)
    return xs, y


def _quad(v: Tensor, M: Tensor) -> Tensor:
    """Batched quadratic form ``v^T M v``."""
    return (v * _mv(M, v)).sum(-1)


def _prior_cost(model: LinearSDE, x0: Tensor,
                prior: Optional[Prior]) -> Tensor:
    if prior is not None:
        S0, v0 = prior
        d0 = x0 - _solve_vec(S0, v0)
        return 0.5 * _quad(d0, S0)
    d0 = x0 - model.m0
    return 0.5 * (d0 * _solve_vec(model.P0, d0)).sum(-1)


def om_cost_linear(model: LinearSDE, ts: Tensor, y: Tensor, x: Tensor,
                   measurement_mask: Optional[Tensor] = None,
                   prior: Optional[Prior] = None) -> Tensor:
    """Discretised Onsager-Machlup / minimum-energy cost of a trajectory,
    with the backward-Euler quadrature the reversed-time solvers use."""
    F, c, H, r, Q, R = model.grids(ts)
    dt = ts[1:] - ts[:-1]
    cost = _prior_cost(model, x[0], prior)
    xr = x[1:]
    resid = (x[1:] - x[:-1]) / dt[..., None] - (_mv(F, xr) + c)
    cost = cost + 0.5 * torch.sum(dt * _quad(resid, torch.linalg.inv(Q)),
                                  dim=0)
    meas = _quad(y - (_mv(H, xr) + r), torch.linalg.inv(R))
    if measurement_mask is not None:
        meas = meas * measurement_mask
    return cost + 0.5 * torch.sum(dt * meas, dim=0)


def om_cost_nonlinear(
    model: NonlinearSDE, ts: Tensor, y: Tensor, x: Tensor,
    divergence_correction: bool = False,
    measurement_mask: Optional[Tensor] = None,
    prior: Optional[Prior] = None,
) -> Tensor:
    """The true (nonlinear) discretised Onsager-Machlup cost of ``x``
    ``(N+1, *R, nx)``, one value per record, with the backward-Euler
    quadrature of the solvers.  ``Q`` and ``R`` are inverted as the
    reference does (``inv``; a constant one once)."""
    dt = ts[1:] - ts[:-1]
    tl = ts[:-1]
    Q = model._eval(model.Q, tl)
    R = model._eval(model.R, tl)
    cost = _prior_cost(model, x[0], prior)
    xr = x[1:]
    resid = (x[1:] - x[:-1]) / dt[..., None] - vmap_points(model.f, xr, tl)
    Qinv = _factor_once(model.Q, Q, torch.linalg.inv)
    cost = cost + 0.5 * torch.sum(dt * _quad(resid, Qinv), dim=0)
    meas = _quad(y - vmap_points(model.h, xr, tl),
                 _factor_once(model.R, R, torch.linalg.inv))
    if measurement_mask is not None:
        meas = meas * measurement_mask
    cost = cost + 0.5 * torch.sum(dt * meas, dim=0)
    if divergence_correction:
        cost = cost + 0.5 * torch.sum(
            dt * vmap_points(model._div_f, xr, tl), dim=0)
    return cost


def _pinv_q(Q: Tensor) -> Tensor:
    """Pseudo-inverse of ``Q`` (one matrix or a grid of them) with the
    reference's cutoff ``rtol = 10 max(m, n) eps`` (torch's default
    cutoff is ten times smaller)."""
    n = Q.shape[-1]
    return torch.linalg.pinv(Q, rtol=10.0 * n * torch.finfo(Q.dtype).eps)


def om_cost_grid(grid: GridLQT, x: Tensor,
                 Qpinv: Optional[Tensor] = None) -> Tensor:
    """Onsager-Machlup cost of ``x`` (ORIGINAL time order, ``(N+1, *R,
    nx)``) under a built grid problem: the objective of a MAP solution.

    ``Q`` may be singular: the dynamics term uses the pseudo-inverse with
    the reference's cutoff ``rtol = 10 max(m, n) eps``.  ``Qpinv`` is that
    pseudo-inverse of a constant Q, one ``(nx, nx)`` matrix factored once
    (the estimator passes it; the quadratic form is then one GEMM over
    every point).  Without it every point's ``grid.Q`` is factored.
    """
    phi = torch.flip(x, (0,))                     # phi_j = x_{N-j}
    dt = grid.dt
    resid = (phi[1:] - phi[:-1]) / dt[..., None] - (
        _mv(grid.F, phi[:-1]) + grid.c)
    if Qpinv is None:
        dyn = _quad(resid, _pinv_q(grid.Q))
    else:
        dyn = (resid * (resid @ Qpinv.mT)).sum(-1)
    cost = 0.5 * torch.sum(dt * dyn, dim=0)
    innov = grid.y - (_mv(grid.H, phi[:-1]) + grid.r)
    cost = cost + 0.5 * torch.sum(dt * _quad(innov, grid.Rinv), dim=0)
    if grid.lin is not None:
        cost = cost + torch.sum(dt * (grid.lin * phi[:-1]).sum(-1), dim=0)
    # terminal (reversed) boundary = the initial prior
    d0 = phi[-1] - _solve_vec(grid.S_T, grid.v_T)
    return cost + 0.5 * _quad(d0, grid.S_T)
