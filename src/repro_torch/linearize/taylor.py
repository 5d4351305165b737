"""First-order Taylor linearisation (the paper's section 4.4 path):
``g(x, t) ~= A x + b`` with ``A = jacfwd(g)(xbar)`` and
``b = g(xbar) - A xbar``.  No residual covariance, so
``grid_lqt_from_nonlinear`` leaves ``Q``/``R`` untouched.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .base import Linearization, register_linearization, vmap_points


def taylor_linearize_point(g: Callable, x, t):
    """``(A, b)`` of the first-order expansion of ``g`` about ``x``: one
    forward-mode Jacobian, which also returns ``g(x, t)``."""
    def g_aux(xx):
        out = g(xx, t)
        return out, out

    A, gx = torch.func.jacfwd(g_aux, has_aux=True)(x)
    return A, gx - A @ x


def taylor_linearize_grid(g: Callable, xb, tl):
    """Grid Taylor expansion: :func:`taylor_linearize_point` at every
    interval left point (``xb`` ``(N, *R, nx)``, ``tl`` ``(N, *R)``) in one
    ``torch.func.vmap`` over all of them."""
    return vmap_points(lambda x, t: taylor_linearize_point(g, x, t), xb, tl)


@dataclasses.dataclass(frozen=True)
class Taylor(Linearization):
    """Jacobian (first-order Taylor) linearisation -- the IEKS default."""

    has_residual = False

    def __call__(self, g: Callable, x, t, cov=None):
        A, b = taylor_linearize_point(g, x, t)
        return A, b, None

    def linearize_grid(self, g: Callable, xb, tl, covs=None):
        A, b = taylor_linearize_grid(g, xb, tl)
        return A, b, None


register_linearization("taylor", Taylor)
