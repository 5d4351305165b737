"""Deterministic synthetic data pipelines.

Stateless by construction: ``batch_at(step)`` is a pure function of
(seed, step), drawn from a ``torch.Generator`` seeded from the pair, so a
restart replays identical batches with no loader state to checkpoint (the
step counter lives in the optimizer state).  The bits are not the
reference's: ``jax.random`` and ``torch.Generator`` differ, so parity tests
feed the reference's batches to both packages.

* ``LMDataPipeline`` -- noisy-copy language modelling: each sequence tiles
  a per-sequence random segment with corruptions; learnable by attending
  to the previous period (loss floor ~= corruption entropy).
* ``TrajectoryDataPipeline`` -- simulated SDE measurement records
  (``core.simulate_linear`` / ``core.simulate_nonlinear``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _generator(seed: int, step: int, device="cpu") -> torch.Generator:
    # SeedSequence mixes the pair into 32 bits, all that the CPU
    # generator's Mersenne twister keeps of a seed
    mixed = int(np.random.SeedSequence([seed, step]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(mixed)


@dataclasses.dataclass(frozen=True)
class LMDataPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    period: int = 64
    corruption: float = 0.1
    embed_dim: int = 0           # >0 -> also emit frame/patch embeddings

    def batch_at(self, step: int) -> dict:
        """``{"tokens", "labels"}``: (B, S) int32 on the CPU (and
        ``"embeddings"`` (B, S, embed_dim) float32 when asked)."""
        g = _generator(self.seed, step)
        B, S, P = self.global_batch, self.seq_len, self.period
        seg = torch.randint(0, self.vocab_size, (B, P), generator=g)
        reps = (S + P) // P + 1
        toks = seg.repeat(1, reps)[:, :S + 1]
        corrupt = torch.rand(toks.shape, generator=g) < self.corruption
        noise = torch.randint(0, self.vocab_size, toks.shape, generator=g)
        toks = torch.where(corrupt, noise, toks).to(torch.int32)
        batch = {"tokens": toks[:, :-1].contiguous(),
                 "labels": toks[:, 1:].contiguous()}
        if self.embed_dim:
            # stub modality frontend: embeddings derived deterministically
            # from the tokens through a fixed random codebook
            code = torch.randn(
                (self.vocab_size, self.embed_dim),
                generator=torch.Generator().manual_seed(self.seed + 7)) * 0.02
            batch["embeddings"] = code[batch["tokens"]]
        return batch


@dataclasses.dataclass(frozen=True)
class TrajectoryDataPipeline:
    """Batches of simulated measurement records for MAP estimation."""
    model: object            # LinearSDE | NonlinearSDE
    ts: torch.Tensor         # (N+1,) grid, on the device to simulate on
    batch: int
    seed: int = 0

    def batch_at(self, step: int) -> dict:
        """``{"x_true": (batch, N+1, nx), "y": (batch, N, ny)}``."""
        from repro_torch.core import simulate_linear, simulate_nonlinear
        from repro_torch.core.sde import LinearSDE

        sim = (simulate_linear if isinstance(self.model, LinearSDE)
               else simulate_nonlinear)
        ts = self.ts[:, None].expand(-1, self.batch)
        xs, ys = sim(self.model, ts,
                     _generator(self.seed, step, self.ts.device))
        return {"x_true": xs.movedim(1, 0), "y": ys.movedim(1, 0)}
