"""Sequential baselines (the paper's comparison algorithms, section 5).

These are the O(N)-span algorithms the parallel methods are held against:

* :func:`sequential_backward`   -- Euler (or rk4) on the Riccati ODEs (15)
  (``euler``/``rk4`` modes) or exact information-form steps
  (``discrete``); equivalent to the Kalman-Bucy filter (22) in original
  time (section 2.5).
* :func:`sequential_rts`        -- + forward Euler of eq. (18) (or the
  exact argmin steps): the sequential continuous-time RTS smoother.
* :func:`sequential_two_filter` -- + forward HJB (51) integration and the
  two-filter combination (48).
"""
from __future__ import annotations

import torch

from .combine import (
    _mv,
    _solve_vec,
    _sym,
    apply_element_to_value,
    elem_min_initial,
    lqt_combine,
)
from .elements import (
    CORE_STEPS,
    InBlockSteps,
    _lin_term,
    _ode_step_backward,
    _riccati_derivs,
    forward_hjb_step,
    identity_element,
    one_step_dynamics,
    one_step_elements,
)
from .types import GridLQT, LQTElement, MAPSolution, Tensor, ValueFn


def _grid_steps(grid: GridLQT):
    """``(dt, F, c, H, r, Q, Rinv, y, lin)`` per substep j (``(*R, ...)``)."""
    fields = (grid.dt, grid.F, grid.c, grid.H, grid.r, grid.Q, grid.Rinv,
              grid.y, _lin_term(grid))
    return [tuple(a[j] for a in fields) for j in range(grid.N)]


def sequential_backward(grid: GridLQT, mode: str = "euler") -> ValueFn:
    """S(tau_j), v(tau_j) for j = 0..N (reversed time), O(N) span."""
    carry = ValueFn(grid.S_T, grid.v_T)
    out = []
    if mode == "discrete":
        elems = one_step_elements(grid)
        for j in range(grid.N - 1, -1, -1):
            carry = apply_element_to_value(
                LQTElement(*(a[j] for a in elems)), carry)
            out.append(carry)
    else:
        for dtk, *coef in reversed(_grid_steps(grid)):
            S, v = _ode_step_backward(
                lambda sv: _riccati_derivs(*sv, *coef), carry, dtk, mode)
            carry = ValueFn(_sym(S), v)
            out.append(carry)
    out = out[::-1]
    # a prior shared across records broadcasts against per-record steps
    S_T = grid.S_T.expand(out[0].S.shape)
    v_T = grid.v_T.expand(out[0].v.shape)
    return ValueFn(torch.stack([o.S for o in out] + [S_T], dim=0),
                   torch.stack([o.v for o in out] + [v_T], dim=0))


def affine_recovery_maps(grid: GridLQT, values: ValueFn,
                         mode: str = "euler",
                         steps: InBlockSteps = CORE_STEPS):
    """Per-substep affine maps phi(tau_{j+1}) = Phi_j phi(tau_j) + beta_j.

    ``euler``/``rk4`` modes: eqs. (18)-(19) with left-point values;
    ``discrete`` mode: the exact argmin step
    ``z* = (I + C_j S_{j+1})^{-1} (A_j phi + b_j + C_j v_{j+1})``, by
    ``steps.recovery_maps``.
    """
    I = torch.eye(grid.nx, dtype=grid.F.dtype, device=grid.F.device)
    if mode == "discrete":
        return steps.recovery_maps(*one_step_dynamics(grid),
                                   values.S[1:], values.v[1:])
    S0 = values.S[:-1]
    v0 = values.v[:-1]
    dt = grid.dt[..., None, None]
    Fbar = grid.F - grid.Q @ S0
    Phi = I + dt * Fbar
    beta = grid.dt[..., None] * (_mv(grid.Q, v0) + grid.c)
    return Phi, beta


def _run_affine(phi0: Tensor, Phi: Tensor, beta: Tensor) -> Tensor:
    """``phi0`` followed by ``phi_{k+1} = Phi_k phi_k + beta_k``."""
    out = [phi0]
    for k in range(Phi.shape[0]):
        out.append(_mv(Phi[k], out[-1]) + beta[k])
    return torch.stack(out, dim=0)


def sequential_rts(grid: GridLQT, mode: str = "euler") -> MAPSolution:
    """Sequential continuous-time RTS smoother (backward + forward)."""
    values = sequential_backward(grid, mode)
    Phi, beta = affine_recovery_maps(grid, values, mode)
    phi = _run_affine(_solve_vec(values.S[0], values.v[0]), Phi, beta)
    return MAPSolution(
        x=torch.flip(phi, (0,)),
        S=torch.flip(values.S, (0,)),
        v=torch.flip(values.v, (0,)))


def two_filter_combine(fwd: LQTElement, S: Tensor, v: Tensor):
    """Eq. (48): phi* = (I + Cbar S)^{-1} (bbar + Cbar v) (+ covariance)."""
    I = torch.eye(S.shape[-1], dtype=S.dtype, device=S.device).expand(
        S.shape)
    M = I + fwd.C @ S
    rhs = torch.cat([(fwd.b + _mv(fwd.C, v)).unsqueeze(-1), fwd.C], dim=-1)
    sol = torch.linalg.solve(M, rhs)
    return sol[..., 0], _sym(sol[..., 1:])


def sequential_two_filter(grid: GridLQT, mode: str = "euler",
                          jitter: float = 1e-9) -> MAPSolution:
    """Sequential two-filter smoother.

    Integrates the forward HJB (51) from the identity element (or composes
    the exact substep elements in ``discrete`` mode), folds the
    free-initial-condition minimisation (eqs. 39/50) pointwise, after
    which (b, C) are the backward-time filter mean/covariance (section
    4.3), and eq. (48) recovers the trajectory.  ``jitter`` regularises
    the near-singular early-time J (few measurements seen yet).
    """
    values = sequential_backward(grid, mode)
    lead = tuple(grid.F.shape[1:-2])                          # record dims
    carry = LQTElement(*(
        a.expand(lead + a.shape)
        for a in identity_element(grid.nx, grid.F.dtype, grid.F.device)))
    fwd = []
    if mode == "discrete":
        elems = one_step_elements(grid)
        for j in range(grid.N):
            carry = lqt_combine(carry, LQTElement(*(a[j] for a in elems)))
            fwd.append(carry)
    else:
        for dtk, *coef in _grid_steps(grid):
            carry = forward_hjb_step(carry, dtk, *coef)
            fwd.append(carry)
    fwd = LQTElement(*(torch.stack(xs, dim=0) for xs in zip(*fwd)))

    folded = elem_min_initial(fwd, jitter=jitter)
    phi_tail, cov_tail = two_filter_combine(folded, values.S[1:],
                                            values.v[1:])
    phi0 = _solve_vec(values.S[0], values.v[0])
    cov0 = torch.linalg.inv(values.S[0])
    phi = torch.cat([phi0[None], phi_tail], dim=0)
    cov = torch.cat([cov0[None], cov_tail], dim=0)
    return MAPSolution(
        x=torch.flip(phi, (0,)),
        S=torch.flip(values.S, (0,)),
        v=torch.flip(values.v, (0,)),
        cov=torch.flip(cov, (0,)))
