"""Attention op over the flash-attention kernel.

``attention`` keeps the reference op's tiling precondition (its kernel's
default 128-row blocks: ``L % min(128, L) == 0`` for q and k) as a
``ValueError``, so the port accepts exactly the shapes the reference
does.  The trainable variant (``attention_trainable``, a ``custom_vjp``
in the reference) waits for the training slice (ROADMAP.md, queue 1).
"""
from __future__ import annotations

from typing import Optional

from .kernel import flash_attention

BLOCK = 128


def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None):
    """q: (B, Hq, Lq, D); k, v: (B, Hkv, Lk, D) -> (B, Hq, Lq, D)."""
    Lq, Lk = q.shape[2], k.shape[2]
    for name, n in (("Lq", Lq), ("Lk", Lk)):
        if n and n % min(BLOCK, n):
            raise ValueError(f"{name}={n} must be a multiple of {BLOCK} "
                             f"(or at most {BLOCK})")
    return flash_attention(q, k, v, causal=causal, window=window)
