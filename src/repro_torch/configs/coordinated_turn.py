"""Paper section 5.2: the coordinated-turn model (eqs. 55-58) -- the
nonlinear experiment behind Fig. 2 (5 IEKS iterations)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.sde import NonlinearSDE


def _f(x, t):
    return torch.stack([x[2], x[3], -x[4] * x[3], x[4] * x[2],
                        torch.zeros_like(x[0])])


def _h(x, t):
    return torch.stack([torch.sqrt(x[0] ** 2 + x[1] ** 2),
                        torch.atan2(x[1], x[0])])


@dataclasses.dataclass(frozen=True)
class CoordinatedTurnConfig:
    t0: float = 0.0
    tf: float = 5.0
    sigma_v: float = 5e-4
    sigma_w: float = 0.02
    iterations: int = 5       # paper: 5 linearisation iterations
    nsub: int = 10
    q_jitter: float = 1e-10   # Q = L W L^T is singular in the position rows

    def model(self, dtype: torch.dtype = torch.float64,
              device=None) -> NonlinearSDE:
        kw = dict(dtype=dtype, device=device)
        L = torch.zeros((5, 3), **kw)
        L[2, 0] = self.sigma_v
        L[3, 1] = self.sigma_v
        L[4, 2] = self.sigma_w
        Q = L @ torch.eye(3, **kw) @ L.T + self.q_jitter * torch.eye(5, **kw)
        return NonlinearSDE(
            f=_f, h=_h, Q=Q, R=torch.diag(torch.tensor([5e-3, 1e-3], **kw)),
            m0=torch.tensor([5.0, 5.0, 0.0, 0.3, 0.0], **kw),
            P0=torch.diag(torch.tensor([0.01, 0.01, 0.01, 0.01, 0.04], **kw)))


def config() -> CoordinatedTurnConfig:
    return CoordinatedTurnConfig()
