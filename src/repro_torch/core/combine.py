"""Associative combination operators (paper eqs. 42, 45-46, and the
value-application step used for within-block interior fills).

All operators broadcast over arbitrary leading axes (time, records): ``@``
and ``torch.linalg.solve`` batch over them, so the same code serves single
pairs, whole blocks and stacked records.

Orientation convention: ``combine(e1, e2)`` composes ``e1`` on the EARLIER
(reversed-time) interval ``[s, gamma]`` with ``e2`` on ``[gamma, t]``,
exactly eq. (42) with ``1 -> (s, gamma)`` and ``2 -> (gamma, t)``.
"""
from __future__ import annotations

import torch

from .types import AffineElement, LQTElement, Tensor, ValueFn


def _sym(M: Tensor) -> Tensor:
    """Numerically symmetrise a (batched) matrix."""
    return 0.5 * (M + M.transpose(-1, -2))


def _eye_like(M: Tensor) -> Tensor:
    n = M.shape[-1]
    return torch.eye(n, dtype=M.dtype, device=M.device).expand(M.shape)


def _mv(M: Tensor, v: Tensor) -> Tensor:
    """Batched matrix-vector product ``M @ v``."""
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _solve_vec(M: Tensor, v: Tensor) -> Tensor:
    """Batched ``M^{-1} v`` (``v`` always read as a batch of vectors)."""
    return torch.linalg.solve(M, v.unsqueeze(-1)).squeeze(-1)


def lqt_combine(e1: LQTElement, e2: LQTElement) -> LQTElement:
    """Eq. (42): min-plus composition of two conditional value functions.

    Two batched linear solves with ``M = I + C1 J2`` (and its transpose
    ``I + J2 C1 = M^T``, since C1 and J2 are symmetric) instead of explicit
    inverses.  Outputs C and J are re-symmetrised to stop round-off drift.
    """
    A1, b1, C1, eta1, J1 = e1
    A2, b2, C2, eta2, J2 = e2

    M = _eye_like(C1) + C1 @ J2          # (..., nx, nx)
    Mt = M.transpose(-1, -2)             # = I + J2 C1

    # Right-hand sides solved against M:   M^{-1} [A1 | b1 + C1 eta2 | C1]
    nx = A1.shape[-1]
    rhs1 = torch.cat(
        [A1, (b1 + _mv(C1, eta2)).unsqueeze(-1), C1], dim=-1)
    sol1 = torch.linalg.solve(M, rhs1)
    MiA1 = sol1[..., :nx]
    Mib = sol1[..., nx]
    MiC1 = sol1[..., nx + 1:]

    # Solved against M^T:   (I + J2 C1)^{-1} [eta2 - J2 b1 | J2 A1]
    rhs2 = torch.cat([(eta2 - _mv(J2, b1)).unsqueeze(-1), J2 @ A1], dim=-1)
    sol2 = torch.linalg.solve(Mt, rhs2)
    Mte = sol2[..., 0]
    MtJA = sol2[..., 1:]

    A1T = A1.transpose(-1, -2)
    A = A2 @ MiA1
    b = _mv(A2, Mib) + b2
    C = _sym(A2 @ MiC1 @ A2.transpose(-1, -2) + C2)
    eta = _mv(A1T, Mte) + eta1
    J = _sym(A1T @ MtJA + J1)
    return LQTElement(A, b, C, eta, J)


def affine_combine(e1: AffineElement, e2: AffineElement) -> AffineElement:
    """Eqs. (45)-(46): compose phi -> Phi2 (Phi1 phi + beta1) + beta2.

    ``e1`` maps over the earlier interval, ``e2`` over the later one.
    """
    return AffineElement(e2.Phi @ e1.Phi, _mv(e2.Phi, e1.beta) + e2.beta)


def apply_element_to_value(e: LQTElement, vf: ValueFn) -> ValueFn:
    """Fold a one-interval element into a terminal value function.

    Computes the (J, eta) block of ``lqt_combine(e, value_as_element(vf))``:

        S' = A^T (I + S C)^{-1} S A + J
        v' = A^T (I + S C)^{-1} (v - S b) + eta

    i.e. one information-form Kalman-Bucy step backwards in reversed time.
    """
    A, b, C, eta, J = e
    S2, v2 = vf
    Mt = _eye_like(C) + S2 @ C
    rhs = torch.cat([(v2 - _mv(S2, b)).unsqueeze(-1), S2 @ A], dim=-1)
    sol = torch.linalg.solve(Mt, rhs)
    At = A.transpose(-1, -2)
    v = _mv(At, sol[..., 0]) + eta
    S = _sym(At @ sol[..., 1:] + J)
    return ValueFn(S, v)


def value_as_element(vf: ValueFn) -> LQTElement:
    """Embed a terminal value function as a scan element (section 3.4).

    A = 0 and b = 0; the prior rides in (J, eta).  With A = 0 the C entry
    never feeds a later combine (the element is always rightmost), so the
    kappa -> infinity boundary of eq. (34) is represented with C = 0.
    """
    S, v = vf
    Z = torch.zeros_like(S)
    z = torch.zeros_like(v)
    return LQTElement(Z, z, Z, v, S)
