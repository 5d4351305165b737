"""``repro_torch.linearize`` -- pluggable linearisation strategies.

The iterated nonlinear smoother needs an affine surrogate of the drift
``f`` and measurement ``h`` at every grid point; this package makes that
step a strategy, as the reference package's ``repro.linearize`` does:

    from repro_torch.linearize import get_linearization
    lin = get_linearization("unscented")      # or "taylor", an instance, ...
    A, b, Omega = lin(g, xbar, t, cov)

Built-ins: ``taylor`` (Jacobians by ``torch.func.jacfwd``, the IEKS
default), and sigma-point statistical linear regression via ``unscented``
/ ``cubature`` / ``gauss_hermite`` (derivative-free, residual covariance
folded into the noise -- the posterior-linearisation smoother of arXiv
2102.00514).  Select with ``IteratedOptions(linearization=...)`` or
``method="sigma_point"``.
"""
from .base import (
    Linearization,
    get_linearization,
    linearization_names,
    register_linearization,
)
from .sigma_points import (
    Cubature,
    GaussHermite,
    SigmaPointFamily,
    SigmaPoints,
    Unscented,
    unit_points,
)
from .slr import SLR, cubature, gauss_hermite, slr_linearize_point, unscented
from .taylor import Taylor, taylor_linearize_grid, taylor_linearize_point

__all__ = [
    "Cubature",
    "GaussHermite",
    "Linearization",
    "SLR",
    "SigmaPointFamily",
    "SigmaPoints",
    "Taylor",
    "Unscented",
    "cubature",
    "gauss_hermite",
    "get_linearization",
    "linearization_names",
    "register_linearization",
    "slr_linearize_point",
    "taylor_linearize_grid",
    "taylor_linearize_point",
    "unit_points",
    "unscented",
]
