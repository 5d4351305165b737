"""Lorenz-96 at its standard size (Lorenz & Emanuel 1998, J. Atmos. Sci.
55:399-414, eq. 1; Lorenz 1996): N = 40 variables on a ring, forcing
F = 8, as an SDE with additive noise, every other variable observed.

    dx_i = ((x_{i+1} - x_{i-2}) x_{i-1} - x_i + F) dt + dbeta_i   (cyclic i)
    y    = (x_0, x_2, ..., x_38) + noise

The field's standard nonlinear test bed for smoothers and filters; here
the state is 40 wide, which the register scan kernel does not take, so
``parallel_kernel`` runs the wide scan kernel.  Q, R, P0 and the
observation layout are set here, not taken from a source; ``m0`` is a
point on the attractor (RK4 at step 0.01 for 10 time units from
``x_i = F``, ``x_19 = F + 0.008``).  The grid is ``coordinated_turn``'s:
tf = 5 time units over 512 blocks of 10 substeps, dt = 2^-10.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core.sde import NonlinearSDE


def drift(x, t, forcing: float):
    """``(x_{i+1} - x_{i-2}) x_{i-1} - x_i + F`` with cyclic indices."""
    return ((torch.roll(x, -1, -1) - torch.roll(x, 2, -1))
            * torch.roll(x, 1, -1) - x + forcing)


def _h(x, t):
    return x[0::2]


@functools.lru_cache(maxsize=None)
def attractor_point(n: int, forcing: float, spin_up: float,
                    step: float) -> tuple:
    """A point on the attractor: RK4 at ``step`` for ``spin_up`` time
    units from ``x_i = F`` with ``x_{n/2 - 1} = F + 0.008``, in float64 on
    the CPU (the same numbers on every device)."""
    x = torch.full((n,), forcing, dtype=torch.float64)
    x[n // 2 - 1] += 0.008
    f = functools.partial(drift, t=None, forcing=forcing)
    for _ in range(round(spin_up / step)):
        k1 = f(x)
        k2 = f(x + 0.5 * step * k1)
        k3 = f(x + 0.5 * step * k2)
        k4 = f(x + step * k3)
        x = x + step / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return tuple(x.tolist())


@dataclasses.dataclass(frozen=True)
class Lorenz96Config:
    n: int = 40
    forcing: float = 8.0
    t0: float = 0.0
    tf: float = 5.0
    q: float = 0.1             # Q = q I (spectral density)
    r: float = 0.05            # R = r I over the observed half
    p0: float = 1.0            # P0 = p0 I
    spin_up: float = 10.0
    spin_step: float = 0.01
    iterations: int = 5
    nsub: int = 10

    def model(self, dtype: torch.dtype = torch.float64,
              device=None) -> NonlinearSDE:
        kw = dict(dtype=dtype, device=device)
        m0 = attractor_point(self.n, self.forcing, self.spin_up,
                             self.spin_step)
        return NonlinearSDE(
            f=functools.partial(drift, forcing=self.forcing), h=_h,
            Q=self.q * torch.eye(self.n, **kw),
            R=self.r * torch.eye(self.n // 2, **kw),
            m0=torch.tensor(m0, **kw), P0=self.p0 * torch.eye(self.n, **kw))


def config() -> Lorenz96Config:
    return Lorenz96Config()
