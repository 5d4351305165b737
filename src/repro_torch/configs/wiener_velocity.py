"""Paper section 5.1: the partially observed Wiener velocity model
(eqs. 52-54) -- the linear experiment behind Fig. 1."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.sde import LinearSDE


@dataclasses.dataclass(frozen=True)
class WienerVelocityConfig:
    t0: float = 0.0
    tf: float = 5.0
    q: float = 4.0           # W = q I2 (paper: 4)
    r: float = 1e-2          # R = r I2
    p0: float = 1e-2         # P0 = p0 I4 (paper)
    nsub: int = 10           # paper: n = 10 substeps per block
    q_jitter: float = 0.0    # solvers never invert Q; keep it singular

    def model(self, dtype: torch.dtype = torch.float64,
              device=None) -> LinearSDE:
        kw = dict(dtype=dtype, device=device)
        F = torch.zeros((4, 4), **kw)
        F[0:2, 2:4] = torch.eye(2, **kw)
        H = torch.cat([torch.eye(2, **kw), torch.zeros((2, 2), **kw)], dim=1)
        L = torch.cat([torch.zeros((2, 2), **kw), torch.eye(2, **kw)], dim=0)
        Q = L @ (self.q * torch.eye(2, **kw)) @ L.T
        if self.q_jitter:
            Q = Q + self.q_jitter * torch.eye(4, **kw)
        return LinearSDE(
            F=F, c=torch.zeros(4, **kw), H=H, r=torch.zeros(2, **kw), Q=Q,
            R=self.r * torch.eye(2, **kw),
            m0=torch.tensor([5.0, 5.0, 0.0, 0.0], **kw),
            P0=self.p0 * torch.eye(4, **kw))
