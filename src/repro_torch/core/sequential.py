"""Sequential baseline (the paper's comparison algorithm, section 5):
the O(N)-span continuous-time RTS smoother, ``discrete`` mode.

* :func:`sequential_backward` -- exact information-form steps, equivalent
  to the Kalman-Bucy filter (22) in original time (section 2.5).
* :func:`sequential_rts`      -- + the exact forward argmin steps.
"""
from __future__ import annotations

import torch

from .combine import _mv, _solve_vec, apply_element_to_value
from .elements import one_step_elements, require_discrete
from .types import GridLQT, MAPSolution, ValueFn


def sequential_backward(grid: GridLQT, mode: str = "euler") -> ValueFn:
    """S(tau_j), v(tau_j) for j = 0..N (reversed time), O(N) span."""
    require_discrete(mode)
    elems = one_step_elements(grid)
    carry = ValueFn(grid.S_T, grid.v_T)
    out = []
    for j in range(grid.N - 1, -1, -1):
        carry = apply_element_to_value(type(elems)(*(a[j] for a in elems)),
                                       carry)
        out.append(carry)
    out = out[::-1]
    # a prior shared across records broadcasts against per-record steps
    S_T = grid.S_T.expand(out[0].S.shape)
    v_T = grid.v_T.expand(out[0].v.shape)
    return ValueFn(torch.stack([o.S for o in out] + [S_T], dim=0),
                   torch.stack([o.v for o in out] + [v_T], dim=0))


def affine_recovery_maps(grid: GridLQT, values: ValueFn,
                         mode: str = "euler"):
    """Per-substep affine maps phi(tau_{j+1}) = Phi_j phi(tau_j) + beta_j:
    the exact argmin step
    ``z* = (I + C_j S_{j+1})^{-1} (A_j phi + b_j + C_j v_{j+1})``."""
    require_discrete(mode)
    e = one_step_elements(grid)
    S1 = values.S[1:]
    v1 = values.v[1:]
    I = torch.eye(grid.nx, dtype=grid.F.dtype, device=grid.F.device)
    M = I + e.C @ S1
    rhs = torch.cat([e.A, (e.b + _mv(e.C, v1)).unsqueeze(-1)], dim=-1)
    sol = torch.linalg.solve(M, rhs)
    return sol[..., :-1], sol[..., -1]


def sequential_rts(grid: GridLQT, mode: str = "euler") -> MAPSolution:
    """Sequential continuous-time RTS smoother (backward + forward)."""
    values = sequential_backward(grid, mode)
    Phi, beta = affine_recovery_maps(grid, values, mode)
    phi = _solve_vec(values.S[0], values.v[0])
    out = [phi]
    for k in range(grid.N):
        phi = _mv(Phi[k], phi) + beta[k]
        out.append(phi)
    return MAPSolution(
        x=torch.flip(torch.stack(out, dim=0), (0,)),
        S=torch.flip(values.S, (0,)),
        v=torch.flip(values.v, (0,)))
