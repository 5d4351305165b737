"""Per-block scan-element construction and within-block fills.

Two element modes, as in the reference package:

* ``euler`` (paper-faithful) / ``rk4``: integrate the backward conditional
  HJB ODEs of eq. (43) over the n substeps of each block, from the
  identity boundary at the block end.
* ``discrete``: each Euler substep of the control problem has a
  CLOSED-FORM conditional value function

      A = I + dt F~,  b = dt c~,  C = dt Q~,
      J = dt H~^T R~^{-1} H~,     eta = dt (H~^T R~^{-1} (y~ - r~) - lin)

  and composing these with the exact combine (42) solves the
  Euler-discretised problem EXACTLY, so parallel == sequential to float
  round-off.

Also the within-block interior fills: the backward value fill (eq. 15 /
information-form steps) and the forward value fill (eq. 51).

Blocks are independent, so where the reference ``vmap``s over blocks these
functions carry the block axis (and any record dims) as leading tensor
dims and loop only over the ``nsub`` substeps inside a block.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from .combine import _mv, _sym, apply_element_to_value, lqt_combine
from .types import GridLQT, LQTElement, Tensor, ValueFn


def _check_blocks(N: int, nsub: int) -> int:
    if N % nsub:
        raise ValueError(f"N={N} not divisible by nsub={nsub}")
    return N // nsub


def _block_view(grid: GridLQT, nsub: int) -> GridLQT:
    """Reshape the substep axis N -> (T, n).  N must be divisible by n."""
    T = _check_blocks(grid.N, nsub)

    def rs(a):
        return None if a is None else a.reshape((T, nsub) + a.shape[1:])

    return GridLQT(
        dt=rs(grid.dt), F=rs(grid.F), c=rs(grid.c), H=rs(grid.H),
        r=rs(grid.r), Q=rs(grid.Q), Rinv=rs(grid.Rinv), y=rs(grid.y),
        S_T=grid.S_T, v_T=grid.v_T, lin=rs(grid.lin),
    )


def _lin_term(grid: GridLQT) -> Tensor:
    if grid.lin is None:
        return torch.zeros_like(grid.c)
    return grid.lin


def one_step_dynamics(grid: GridLQT) -> Tuple[Tensor, Tensor, Tensor]:
    """``(A, b, C)`` of the single-substep elements (N, ...): the parts
    that the trajectory's recovery needs, without the measurement's."""
    dt = grid.dt[..., None, None]
    I = torch.eye(grid.nx, dtype=grid.F.dtype, device=grid.F.device)
    return I + dt * grid.F, grid.dt[..., None] * grid.c, dt * grid.Q


def one_step_elements(grid: GridLQT) -> LQTElement:
    """Closed-form single-substep elements (N, ...) -- ``discrete`` mode."""
    dt = grid.dt[..., None, None]
    HtRi = grid.H.transpose(-1, -2) @ grid.Rinv
    A, b, C = one_step_dynamics(grid)
    J = dt * (HtRi @ grid.H)
    eta = grid.dt[..., None] * (
        _mv(HtRi, grid.y - grid.r) - _lin_term(grid))
    return LQTElement(A, b, C, eta, J)


def terminal_element(grid: GridLQT) -> LQTElement:
    """The prior element ``a_T`` (section 3.4); A = 0 makes its C inert."""
    Z = torch.zeros_like(grid.S_T)
    z = torch.zeros_like(grid.v_T)
    return LQTElement(Z, z, Z, grid.v_T, grid.S_T)


def identity_element(nx: int, dtype: torch.dtype, device=None) -> LQTElement:
    """V(phi, tau; z, tau): the zero-length-interval identity (eq. 34)."""
    I = torch.eye(nx, dtype=dtype, device=device)
    Z = torch.zeros((nx, nx), dtype=dtype, device=device)
    z = torch.zeros((nx,), dtype=dtype, device=device)
    return LQTElement(I, z, Z, z, Z)


def _bcast(d: Tensor, a: Tensor) -> Tensor:
    """Step sizes ``d`` ``(*lead)`` shaped to scale ``a`` ``(*lead, ...)``."""
    return d.reshape(d.shape + (1,) * (a.dim() - d.dim()))


def _hjb_derivs(e: LQTElement, F, c, H, r, Q, Rinv, y, lin) -> LQTElement:
    """Right-hand sides of eq. (43) (with the optional linear-cost term)."""
    A, b, C, eta, J = e
    Ft = F.transpose(-1, -2)
    HtRi = H.transpose(-1, -2) @ Rinv
    innov = _mv(HtRi, y - r)
    dA = -A @ (Q @ J + F)
    db = -_mv(A, _mv(Q, eta) + c)
    dC = -A @ Q @ A.transpose(-1, -2)
    deta = _mv(J, _mv(Q, eta) + c) - _mv(Ft, eta) - innov + lin
    dJ = J @ Q @ J - J @ F - Ft @ J - HtRi @ H
    return LQTElement(dA, db, dC, deta, dJ)


def _riccati_derivs(S, v, F, c, H, r, Q, Rinv, y, lin):
    """Right-hand sides of the Riccati equations (15) for (S, v)."""
    Ft = F.transpose(-1, -2)
    HtRi = H.transpose(-1, -2) @ Rinv
    dS = S @ Q @ S - S @ F - Ft @ S - HtRi @ H
    dv = _mv(S, _mv(Q, v) + c) - _mv(Ft, v) - _mv(HtRi, y - r) + lin
    return dS, dv


def _ode_step_backward(deriv_fn, y, dtk: Tensor, integrator: str):
    """One backward step y(s - dt) of an autonomous-per-interval ODE over
    a tuple of tensors ``y``; ``dtk`` carries the leading (block, record)
    dims of the step.

    ``rk4`` treats the interval's coefficients as frozen (they are grid
    samples) but integrates the state nonlinearity (the Riccati quadratic
    terms) to 4th order -- the reference's accuracy/stiffness upgrade over
    the paper's explicit Euler.
    """
    def axpy(a, d, s):           # a + s * d, s broadcast over d's trailing
        return a + _bcast(s, d) * d

    if integrator == "euler":
        k1 = deriv_fn(y)
        return type(y)(*(a - _bcast(dtk, d) * d for a, d in zip(y, k1)))
    if integrator == "rk4":
        h = -dtk
        k1 = deriv_fn(y)
        k2 = deriv_fn(type(y)(*(axpy(a, d, 0.5 * h) for a, d in zip(y, k1))))
        k3 = deriv_fn(type(y)(*(axpy(a, d, 0.5 * h) for a, d in zip(y, k2))))
        k4 = deriv_fn(type(y)(*(axpy(a, d, h) for a, d in zip(y, k3))))
        return type(y)(*(
            a + _bcast(h / 6.0, d1) * (d1 + 2 * d2 + 2 * d3 + d4)
            for a, d1, d2, d3, d4 in zip(y, k1, k2, k3, k4)))
    raise ValueError(f"unknown integrator: {integrator}")


def _substeps(grid: GridLQT, nsub: int):
    """The block view's coefficients, one tuple per substep ``l``:
    ``(dt, F, c, H, r, Q, Rinv, y, lin)`` each ``(T, *R, ...)``."""
    g = _block_view(grid, nsub)
    lin = _lin_term(grid).reshape(g.c.shape)
    fields = (g.dt, g.F, g.c, g.H, g.r, g.Q, g.Rinv, g.y, lin)
    return [tuple(a[:, l] for a in fields) for l in range(nsub)]


def euler_block_elements(grid: GridLQT, nsub: int,
                         integrator: str = "euler") -> LQTElement:
    """Paper mode: per-block ODE integration of (43), all blocks at once.

    Within each block the integration runs BACKWARD from the identity
    boundary at the block end (eq. 34: A=I, b=0, C=0, eta=0, J=0), using
    the substep-l coefficients for step [tau_l, tau_l+1].  ``integrator``:
    "euler" (paper) or "rk4" (see ``_ode_step_backward``).
    """
    steps = _substeps(grid, nsub)
    e = identity_element(grid.nx, grid.F.dtype, grid.F.device)
    for dtk, *coef in reversed(steps):
        e = _ode_step_backward(lambda ee: _hjb_derivs(ee, *coef), e, dtk,
                               integrator)
    return e


def discrete_recovery_maps(A: Tensor, b: Tensor, C: Tensor, S1: Tensor,
                           v1: Tensor) -> Tuple[Tensor, Tensor]:
    """The exact argmin step ``z* = (I + C S1)^{-1} (A phi + b + C v1)`` of
    each substep as its affine map ``(Phi, beta)``."""
    I = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    M = I + C @ S1
    rhs = torch.cat([A, (b + _mv(C, v1)).unsqueeze(-1)], dim=-1)
    sol = torch.linalg.solve(M, rhs)
    return sol[..., :-1], sol[..., -1]


class InBlockSteps(NamedTuple):
    """The in-block work of ``discrete`` mode: ``fold(e1, e2)`` composes
    two substep elements (eq. 42), ``value_step(e, value)`` takes a value
    back across one substep, and ``recovery_maps(A, b, C, S1, v1)`` gives
    each substep's argmin map ``(Phi, beta)``.  :data:`CORE_STEPS` are the
    core's own; a kernel package may bring its own set
    (:func:`repro_torch.core.parallel.parallel_rts`'s ``steps``)."""
    fold: Callable
    value_step: Callable
    recovery_maps: Callable


CORE_STEPS = InBlockSteps(lqt_combine, apply_element_to_value,
                          discrete_recovery_maps)


def discrete_block_elements(
    grid: GridLQT, nsub: int, steps: InBlockSteps = CORE_STEPS,
) -> Tuple[LQTElement, LQTElement]:
    """Exact composition mode: block elements by in-block combine fold
    (``steps.fold``).

    Returns ``(block_elems (T, ...), substep_elems (T, n, ...))``.
    """
    T = _check_blocks(grid.N, nsub)
    sub = LQTElement(*(a.reshape((T, nsub) + a.shape[1:])
                       for a in one_step_elements(grid)))
    out = LQTElement(*(a[:, 0] for a in sub))
    for l in range(1, nsub):
        out = steps.fold(out, LQTElement(*(a[:, l] for a in sub)))
    return out, sub


def backward_value_fill_discrete(sub_elems: LQTElement, boundary: ValueFn,
                                 steps: InBlockSteps = CORE_STEPS
                                 ) -> ValueFn:
    """Exact information-form steps inside each block (``discrete`` mode),
    each by ``steps.value_step``.

    ``boundary`` holds (S, v) at the RIGHT end of each block (``(T, ...)``);
    returns the values at the LEFT point of every substep (``(T, n, ...)``).
    """
    nsub = sub_elems.A.shape[1]
    carry = boundary
    out = [None] * nsub
    for l in range(nsub - 1, -1, -1):
        carry = steps.value_step(
            LQTElement(*(a[:, l] for a in sub_elems)), carry)
        out[l] = carry
    return ValueFn(torch.stack([o.S for o in out], dim=1),
                   torch.stack([o.v for o in out], dim=1))


def backward_value_fill_euler(grid: GridLQT, nsub: int, boundary: ValueFn,
                              integrator: str = "euler") -> ValueFn:
    """ODE-integrate the Riccati eqs. (15) backwards inside each block.

    ``boundary`` holds (S, v) at the RIGHT end of each block (``(T, ...)``);
    returns per-substep values at the LEFT points of every substep
    (``(T, n, ...)``).  ``integrator``: euler (paper) / rk4.
    """
    steps = _substeps(grid, nsub)
    carry = boundary
    out = [None] * nsub
    for l in range(nsub - 1, -1, -1):
        dtk, *coef = steps[l]
        S, v = _ode_step_backward(
            lambda sv: _riccati_derivs(*sv, *coef), carry, dtk, integrator)
        carry = out[l] = ValueFn(_sym(S), v)
    return ValueFn(torch.stack([o.S for o in out], dim=1),
                   torch.stack([o.v for o in out], dim=1))


def forward_hjb_step(e: LQTElement, dtk, F, c, H, r, Q, Rinv, y,
                     lin) -> LQTElement:
    """One explicit Euler step of the forward HJB ODEs (51) (all five
    equations, C and J re-symmetrised)."""
    A, b, C, eta, J = e
    HtRi = H.transpose(-1, -2) @ Rinv
    CHtRi = C @ HtRi
    innov = _mv(HtRi, y - r)
    At = A.transpose(-1, -2)
    dA = -CHtRi @ (H @ A) + F @ A
    db = (_mv(C, innov) + _mv(F, b) + c
          - _mv(CHtRi, _mv(H, b)) - _mv(C, lin))
    dC = -CHtRi @ (H @ C) + Q + F @ C + C @ F.transpose(-1, -2)
    deta = _mv(At, innov - _mv(HtRi, _mv(H, b)) - lin)
    dJ = At @ HtRi @ (H @ A)
    def step(d):
        return _bcast(dtk, d) * d

    return LQTElement(A + step(dA), b + step(db), _sym(C + step(dC)),
                      eta + step(deta), _sym(J + step(dJ)))


def forward_value_fill_euler(grid: GridLQT, nsub: int,
                             left: LQTElement) -> LQTElement:
    """Euler-integrate the forward HJB ODEs (51) inside each block.

    ``left`` holds the forward conditional value function parameters at
    the LEFT end of each block (``(T, ...)``); returns parameters at the
    RIGHT point of every substep (``(T, n, ...)``).  All five equations
    are propagated (a full-rank left element, identity for block-0
    interiors via eq. 39, needs all five).
    """
    carry = left
    out = []
    for dtk, *coef in _substeps(grid, nsub):
        carry = forward_hjb_step(carry, dtk, *coef)
        out.append(carry)
    return LQTElement(*(torch.stack(xs, dim=1) for xs in zip(*out)))


def forward_value_fill_discrete(sub_elems: LQTElement,
                                left: LQTElement) -> LQTElement:
    """Exact in-block forward combine (``discrete`` mode): ``(T, n, ...)``
    elements from ``left`` ``(T, ...)``."""
    carry = left
    out = []
    for l in range(sub_elems.A.shape[1]):
        carry = lqt_combine(carry, LQTElement(*(a[:, l] for a in sub_elems)))
        out.append(carry)
    return LQTElement(*(torch.stack(xs, dim=1) for xs in zip(*out)))
