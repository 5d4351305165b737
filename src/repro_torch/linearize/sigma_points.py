"""Sigma-point families: unit weight/point generation for SLR.

Every family generates points for the STANDARD normal in R^n (unit
points); :mod:`repro_torch.linearize.slr` shifts and scales them through
the Cholesky factor of the actual spread covariance.  Generation is
host-side numpy on static shapes, memoised per ``(family, n)``, and
converted to the caller's dtype and device at use.  This module is the
port's own copy of the reference package's (numpy only in both).

Families (S = point count for state dimension n):

* :class:`Unscented` -- ``2n + 1`` points (Julier-Uhlmann UT with the
  ``alpha``/``beta``/``kappa`` parametrisation).  The default
  ``kappa=0`` keeps every weight non-negative for all n (the classic
  ``kappa = 3 - n`` goes negative for n > 3, which can make the SLR
  residual covariance indefinite).
* :class:`Cubature` -- ``2n`` points (third-degree spherical-radial
  rule; the UT with the centre point dropped).
* :class:`GaussHermite` -- ``order**n`` tensor-product Gauss-Hermite
  points (exact for polynomials up to degree ``2*order - 1`` per axis;
  exponential in n -- use for small state dimensions).

All weight vectors satisfy ``sum(wm) == 1`` (mean consistency) and
reproduce the first two moments of the generating Gaussian to machine
precision.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import NamedTuple, Optional

import numpy as np


class SigmaPoints(NamedTuple):
    """Unit sigma points for the standard normal in R^n (host arrays)."""

    points: np.ndarray  # (S, n) unit-space points
    wm: np.ndarray      # (S,) mean weights, sum to 1
    wc: np.ndarray      # (S,) covariance weights


@dataclasses.dataclass(frozen=True)
class SigmaPointFamily:
    """Base class: a hashable, frozen description of one point rule."""

    def build(self, n: int) -> SigmaPoints:
        raise NotImplementedError

    def num_points(self, n: int) -> int:
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__.lower()


@dataclasses.dataclass(frozen=True)
class Unscented(SigmaPointFamily):
    """Unscented transform points (2n + 1).

    ``lambda = alpha^2 (n + kappa) - n`` must satisfy ``n + lambda > 0``;
    ``kappa=None`` resolves to the all-weights-non-negative ``0.0``
    default (pass ``3 - n`` for the classic heuristic).
    """

    alpha: float = 1.0
    beta: float = 0.0
    kappa: Optional[float] = None

    def __post_init__(self) -> None:
        if not (isinstance(self.alpha, (int, float)) and self.alpha > 0):
            raise ValueError(f"alpha must be > 0, got {self.alpha!r}")
        if not isinstance(self.beta, (int, float)):
            raise ValueError(f"beta must be a float, got {self.beta!r}")
        if self.kappa is not None and not isinstance(self.kappa,
                                                     (int, float)):
            raise ValueError(
                f"kappa must be None (auto) or a float, got {self.kappa!r}")

    def build(self, n: int) -> SigmaPoints:
        kappa = 0.0 if self.kappa is None else float(self.kappa)
        lam = self.alpha ** 2 * (n + kappa) - n
        if n + lam <= 0:
            raise ValueError(
                f"unscented scaling n + lambda must be > 0; got "
                f"n={n}, alpha={self.alpha}, kappa={kappa} "
                f"(lambda={lam})")
        s = np.sqrt(n + lam)
        pts = np.concatenate(
            [np.zeros((1, n)), s * np.eye(n), -s * np.eye(n)], axis=0)
        wi = 1.0 / (2.0 * (n + lam))
        wm = np.full(2 * n + 1, wi)
        wm[0] = lam / (n + lam)
        wc = wm.copy()
        wc[0] += 1.0 - self.alpha ** 2 + self.beta
        return SigmaPoints(pts, wm, wc)

    def num_points(self, n: int) -> int:
        return 2 * n + 1


@dataclasses.dataclass(frozen=True)
class Cubature(SigmaPointFamily):
    """Third-degree spherical-radial cubature points (2n)."""

    def build(self, n: int) -> SigmaPoints:
        s = np.sqrt(float(n))
        pts = np.concatenate([s * np.eye(n), -s * np.eye(n)], axis=0)
        w = np.full(2 * n, 1.0 / (2 * n))
        return SigmaPoints(pts, w, w.copy())

    def num_points(self, n: int) -> int:
        return 2 * n


@dataclasses.dataclass(frozen=True)
class GaussHermite(SigmaPointFamily):
    """Tensor-product Gauss-Hermite points (``order**n``)."""

    order: int = 3

    def __post_init__(self) -> None:
        # order 1 is the single midpoint: it cannot reproduce a
        # covariance, which SLR's regression divides by -- require the
        # first order whose quadrature matches second moments.
        if not isinstance(self.order, int) or self.order < 2:
            raise ValueError(
                f"order must be an int >= 2, got {self.order!r}")

    def build(self, n: int) -> SigmaPoints:
        if self.order ** n > 200_000:
            raise ValueError(
                f"gauss_hermite(order={self.order}) needs {self.order}**{n} "
                f"= {self.order ** n} points for nx={n}; use a lower order "
                f"or the unscented/cubature families")
        # probabilists' Hermite quadrature: weight exp(-x^2/2), total
        # mass sqrt(2 pi) -- normalise so the 1-D weights sum to 1.
        x1, w1 = np.polynomial.hermite_e.hermegauss(self.order)
        w1 = w1 / np.sqrt(2.0 * np.pi)
        idx = list(itertools.product(range(self.order), repeat=n))
        pts = np.asarray([[x1[i] for i in multi] for multi in idx])
        w = np.asarray([np.prod([w1[i] for i in multi]) for multi in idx])
        return SigmaPoints(pts.reshape(len(idx), n), w, w.copy())

    def num_points(self, n: int) -> int:
        return self.order ** n


@functools.lru_cache(maxsize=None)
def unit_points(family: SigmaPointFamily, n: int) -> SigmaPoints:
    """Memoised host-side generation: families are frozen/hashable, so
    one ``(family, n)`` pair is built exactly once per process."""
    return family.build(n)
