"""Statistical linear regression (SLR) through sigma points.

Instead of differentiating ``g`` at a point, SLR fits the best affine
surrogate *in expectation* under a Gaussian spread ``N(m, P)`` around the
nominal point (Yaghoobi et al., arXiv 2102.00514, section 3):

    zbar = E[g(x)]            (sigma-point quadrature)
    Pxz  = Cov[x, g(x)]
    Pzz  = Cov[g(x)]
    A    = Pxz^T P^{-1}
    b    = zbar - A m
    Omega = Pzz - A P A^T     (PSD linearisation-error covariance)

``Omega`` is folded into the process / measurement noise by
``grid_lqt_from_nonlinear`` (``Q + Omega_f``, ``R + Omega_h``), which turns
the iterated smoother into the posterior-linearisation smoother.  For an
affine ``g`` the regression is exact: ``A`` and ``b`` are recovered to
machine precision and ``Omega == 0``.

A grid is regressed in one batch: ``g`` is evaluated at all S points of
all grid points in one ``torch.func.vmap``, and the weighted moments are
batched contractions.  The spread covariance is factored (Cholesky for
the points, LU for ``P^{-1}``) as it is given: a shared ``(nx, nx)``
spread -- the grid builder's ``P0`` -- is factored once and broadcast,
never once per grid point.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import obs
from repro_torch.obs.metrics import inc_per_entry

from .base import Linearization, register_linearization, vmap_points
from .sigma_points import (
    Cubature,
    GaussHermite,
    SigmaPointFamily,
    Unscented,
    unit_points,
)


def _regress(g: Callable, m, t, P, family: SigmaPointFamily):
    """SLR of ``g`` about ``N(m, P)`` at every point: ``m`` ``(*L, nx)``,
    ``t`` ``(*L)``, ``P`` ``(nx, nx)`` shared or ``(*L, nx, nx)``."""
    unit = unit_points(family, m.shape[-1])
    kw = dict(dtype=m.dtype, device=m.device)
    pts = torch.as_tensor(unit.points, **kw)                 # (S, nx)
    wm = torch.as_tensor(unit.wm, **kw)
    wc = torch.as_tensor(unit.wc, **kw)

    L = torch.linalg.cholesky(P)
    xs = m.unsqueeze(-2) + pts @ L.mT                         # (*L, S, nx)
    ts = t.unsqueeze(-1).expand(xs.shape[:-1])
    zs = vmap_points(g, xs, ts)                               # (*L, S, nz)

    zbar = torch.einsum("s,...sj->...j", wm, zs)
    dx = xs - m.unsqueeze(-2)
    dz = zs - zbar.unsqueeze(-2)
    Pxz = torch.einsum("s,...si,...sj->...ij", wc, dx, dz)
    Pzz = torch.einsum("s,...si,...sj->...ij", wc, dz, dz)

    # A = Pxz^T P^{-1} via the solve against the (PD) spread covariance
    LU, piv = torch.linalg.lu_factor(P)
    A = torch.linalg.lu_solve(LU, piv, Pxz).mT
    b = zbar - (A @ m.unsqueeze(-1)).squeeze(-1)
    Omega = Pzz - A @ P @ A.mT
    return A, b, 0.5 * (Omega + Omega.mT)


def slr_linearize_point(g: Callable, m, t, cov, family: SigmaPointFamily,
                        spread: float = 1.0):
    """SLR of ``g(., t)`` about ``N(m, spread * cov)``.

    ``m`` ``(nx,)``, ``t`` a scalar tensor, ``cov`` ``(nx, nx)`` (symmetric
    PD).  Returns ``(A, b, Omega)`` with ``Omega`` symmetrised PSD
    ``(nz, nz)``.
    """
    t = torch.as_tensor(t, dtype=m.dtype, device=m.device)
    return _regress(g, m, t, spread * cov, family)


@dataclasses.dataclass(frozen=True)
class SLR(Linearization):
    """Sigma-point statistical linear regression.

    ``family`` picks the quadrature rule; ``spread`` scales the
    covariance the regression averages over (1.0 = use the supplied
    spread covariance as-is).  The grid builder supplies the model's
    ``P0`` as the spread covariance -- a prior-width proxy, since
    posterior covariances are not plumbed through -- so the default
    shrinks it (``spread=0.01``) toward the posterior scale; as
    ``spread -> 0`` SLR converges to Taylor for smooth models.
    """

    family: SigmaPointFamily = Unscented()
    spread: float = 0.01

    has_residual = True

    def __post_init__(self) -> None:
        if not isinstance(self.family, SigmaPointFamily):
            raise TypeError(
                f"family must be a SigmaPointFamily, got "
                f"{type(self.family).__name__}")
        if not (isinstance(self.spread, (int, float)) and self.spread > 0):
            raise ValueError(f"spread must be > 0, got {self.spread!r}")

    def __call__(self, g: Callable, x, t, cov=None):
        if cov is None:
            raise ValueError(
                "SLR needs a spread covariance (cov=None is only valid for "
                "derivative-based linearisations)")
        return slr_linearize_point(g, x, t, cov, self.family, self.spread)

    def linearize_grid(self, g: Callable, xb, tl, covs=None):
        """``xb`` ``(N, *R, nx)``, ``tl`` ``(N, *R)``; ``covs`` the spread
        covariance, ``(nx, nx)`` shared by every point or
        ``(N, *R, nx, nx)``."""
        if covs is None:
            raise ValueError(
                "SLR needs per-point spread covariances on the grid")
        if obs.enabled():
            # regressions performed by this call (every grid point of
            # every record), on a cache entry's first run only; the
            # reference counts once per traced call site
            points = xb[..., 0].numel()
            inc_per_entry("linearize.slr.regressions", points)
            inc_per_entry("linearize.slr.sigma_points",
                          points * self.family.num_points(xb.shape[-1]))
        with obs.trace_span("slr"):
            return _regress(g, xb, tl, self.spread * covs, self.family)

    @property
    def obs_name(self) -> str:
        return self.family.name

    def num_points(self, n: int) -> int:
        return self.family.num_points(n)


def unscented(alpha: float = 1.0, beta: float = 0.0, kappa=None,
              spread: float = 0.01) -> SLR:
    """SLR through unscented-transform points (2n + 1)."""
    return SLR(Unscented(alpha, beta, kappa), spread)


def cubature(spread: float = 0.01) -> SLR:
    """SLR through spherical-radial cubature points (2n)."""
    return SLR(Cubature(), spread)


def gauss_hermite(order: int = 3, spread: float = 0.01) -> SLR:
    """SLR through tensor-product Gauss-Hermite points (order**n)."""
    return SLR(GaussHermite(order), spread)


register_linearization("unscented", unscented)
register_linearization("cubature", cubature)
register_linearization("gauss_hermite", gauss_hermite)
