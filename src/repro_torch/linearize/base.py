"""The ``Linearization`` strategy protocol and its registry.

A linearisation turns one nonlinear function ``g(x, t)`` into the affine
surrogate ``g(x, t) ~= A x + b`` about a nominal point, optionally with a
residual covariance ``Omega`` quantifying the surrogate's error:

    (A, b, Omega) = linearization(g, xbar, t, cov)

``cov`` is the spread a regression strategy may average over;
derivative-based strategies ignore it.  ``Omega`` is ``None`` for
exact-at-a-point strategies (Taylor) and a PSD matrix for regression
strategies (sigma-point SLR), whose residual ``grid_lqt_from_nonlinear``
folds into the noise (``Q + Omega_f``, ``R + Omega_h``).

Strategies are frozen dataclasses (hashable, so they ride inside the
frozen options) and stateless.  ``g`` is a torch function of one point
``x`` ``(nx,)`` and a scalar time tensor ``t``; grids are evaluated with
``torch.func.vmap`` over all points at once.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

Array = torch.Tensor


def vmap_points(fn: Callable, *args: torch.Tensor):
    """``fn`` over every grid point: each ``args[i]`` has the leading
    (time, record) dims of ``args[-1]`` (the times) and one point's shape
    after them.  The leading dims are flattened into one ``vmap``."""
    lead = args[-1].shape
    flat = [a.reshape((-1,) + a.shape[len(lead):]) for a in args]
    out = torch.func.vmap(fn)(*flat)
    if isinstance(out, tuple):
        return tuple(o.reshape(lead + o.shape[1:]) for o in out)
    return out.reshape(lead + out.shape[1:])


@dataclasses.dataclass(frozen=True)
class Linearization:
    """Base strategy: affine surrogate of ``g(x, t)`` about a point.

    Subclasses implement :meth:`__call__` (one grid point) and declare
    ``has_residual``: ``False`` means ``Omega`` is always ``None`` and
    ``grid_lqt_from_nonlinear`` leaves the noise untouched.
    """

    #: does this strategy produce a residual covariance Omega?
    has_residual = False

    def __call__(self, g: Callable, x, t, cov=None) -> Tuple:
        """Linearise ``g`` about ``x`` (spread ``cov``) at time ``t``;
        returns ``(A, b, Omega)`` with ``Omega`` possibly ``None``."""
        raise NotImplementedError

    def linearize_grid(self, g: Callable, xb, tl, covs=None):
        """Linearisation over a grid of nominal points: ``xb``
        ``(N, *R, nx)``, ``tl`` ``(N, *R)``, ``covs`` the spread
        covariance (``None`` for derivative strategies).  Returns grid
        tensors ``(A, b, Omega)`` -- ``Omega`` is ``None`` iff
        ``has_residual`` is ``False``."""
        raise NotImplementedError

    @property
    def obs_name(self) -> str:
        """Metric-taxonomy slug (``linearize.<obs_name>.*``)."""
        return type(self).__name__.lower()

    def num_points(self, n: int) -> int:
        """Function evaluations per grid point (1 for derivative
        strategies; the sigma-point count for regression strategies)."""
        return 1


_LINEARIZATIONS: Dict[str, Callable[[], Linearization]] = {}


def register_linearization(name: str, factory: Callable[[], Linearization],
                           *, overwrite: bool = False) -> None:
    """Register ``factory`` (zero-arg, returns a :class:`Linearization`)
    under ``name``, making it a valid ``linearization=`` string."""
    if name in _LINEARIZATIONS and not overwrite:
        raise ValueError(f"linearization {name!r} already registered")
    _LINEARIZATIONS[name] = factory


def linearization_names() -> Tuple[str, ...]:
    return tuple(_LINEARIZATIONS)


def get_linearization(spec: "Optional[str | Linearization]") -> Linearization:
    """Resolve a ``linearization=`` value: ``None`` -> the Taylor default,
    a registered name -> its default instance, an instance -> itself."""
    if spec is None:
        spec = "taylor"
    if isinstance(spec, Linearization):
        return spec
    if isinstance(spec, str):
        try:
            return _LINEARIZATIONS[spec]()
        except KeyError:
            raise ValueError(
                f"linearization must be one of {linearization_names()} or a "
                f"Linearization instance, got {spec!r}") from None
    raise TypeError(
        f"linearization must be a str or Linearization instance, got "
        f"{type(spec).__name__}")
