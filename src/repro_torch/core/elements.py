"""Per-block scan-element construction and within-block fills.

This slice ports the ``discrete`` element mode: each Euler substep of the
control problem has a CLOSED-FORM conditional value function

    A = I + dt F~,  b = dt c~,  C = dt Q~,
    J = dt H~^T R~^{-1} H~,     eta = dt (H~^T R~^{-1} (y~ - r~) - lin)

and composing these with the exact combine (42) solves the
Euler-discretised problem EXACTLY, so parallel == sequential to float
round-off.  The paper's ``euler``/``rk4`` ODE modes are not ported yet
(ROADMAP.md, queue 1).

Blocks are independent, so where the reference ``vmap``s over blocks these
functions carry the block axis (and any record dims) as leading tensor
dims and loop only over the ``nsub`` substeps inside a block.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .combine import _mv, apply_element_to_value, lqt_combine
from .types import GridLQT, LQTElement, Tensor, ValueFn


def require_discrete(mode: str) -> None:
    """Reject the element modes this port does not implement yet."""
    if mode in ("euler", "rk4"):
        raise NotImplementedError(
            f"mode={mode!r} (the paper's ODE element modes) is not ported "
            f"yet; see ROADMAP.md, queue 1. Use mode='discrete'.")
    if mode != "discrete":
        raise ValueError(f"unknown element mode: {mode!r}")


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


def one_step_elements(grid: GridLQT) -> LQTElement:
    """Closed-form single-substep elements (N, ...) -- ``discrete`` mode."""
    dt = grid.dt[..., None, None]
    I = torch.eye(grid.nx, dtype=grid.F.dtype, device=grid.F.device)
    HtRi = grid.H.transpose(-1, -2) @ grid.Rinv
    A = I + dt * grid.F
    b = grid.dt[..., None] * grid.c
    C = dt * grid.Q
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


def discrete_block_elements(
    grid: GridLQT, nsub: int
) -> Tuple[LQTElement, LQTElement]:
    """Exact composition mode: block elements by in-block combine fold.

    Returns ``(block_elems (T, ...), substep_elems (T, n, ...))``.
    """
    T = _check_blocks(grid.N, nsub)
    sub = LQTElement(*(a.reshape((T, nsub) + a.shape[1:])
                       for a in one_step_elements(grid)))
    out = LQTElement(*(a[:, 0] for a in sub))
    for l in range(1, nsub):
        out = lqt_combine(out, LQTElement(*(a[:, l] for a in sub)))
    return out, sub


def backward_value_fill_discrete(sub_elems: LQTElement,
                                 boundary: ValueFn) -> ValueFn:
    """Exact information-form steps inside each block (``discrete`` mode).

    ``boundary`` holds (S, v) at the RIGHT end of each block (``(T, ...)``);
    returns the values at the LEFT point of every substep (``(T, n, ...)``).
    """
    nsub = sub_elems.A.shape[1]
    carry = boundary
    out = [None] * nsub
    for l in range(nsub - 1, -1, -1):
        carry = apply_element_to_value(
            LQTElement(*(a[:, l] for a in sub_elems)), carry)
        out[l] = carry
    return ValueFn(torch.stack([o.S for o in out], dim=1),
                   torch.stack([o.v for o in out], dim=1))
