"""``repro_torch.linearize`` -- pluggable linearisation strategies.

The iterated nonlinear smoother needs an affine surrogate of the drift
``f`` and measurement ``h`` at every grid point; this package makes that
step a strategy, as the reference package's ``repro.linearize`` does:

    from repro_torch.linearize import get_linearization
    lin = get_linearization("taylor")         # or an instance
    A, b, Omega = lin(g, xbar, t)

Ported: ``taylor`` (Jacobians by ``torch.func.jacfwd``, the IEKS default).
The sigma-point strategies (``unscented``, ``cubature``,
``gauss_hermite``) are not ported yet: naming one raises
``NotImplementedError`` (ROADMAP.md, queue 1).
"""
from .base import (
    Linearization,
    get_linearization,
    linearization_names,
    register_linearization,
)
from .taylor import Taylor, taylor_linearize_grid, taylor_linearize_point

__all__ = [
    "Linearization",
    "Taylor",
    "get_linearization",
    "linearization_names",
    "register_linearization",
    "taylor_linearize_grid",
    "taylor_linearize_point",
]
