"""Attention ops over the flash-attention kernel.

``attention`` keeps the reference op's tiling precondition (its kernel's
default 128-row blocks: ``L % min(128, L) == 0`` for q and k) as a
``ValueError``, so the port accepts exactly the shapes the reference
does.  ``attention_trainable`` is the reference's ``custom_vjp`` as a
``torch.autograd.Function``: the forward pass is the kernel, the backward
pass is autograd through the plain version (``ref.mha_ref``), recomputed
from the saved q, k, v.  There is no backward kernel, in the reference
either.
"""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import flash_attention
from .ref import mha_ref

BLOCK = 128


def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None):
    """q: (B, Hq, Lq, D); k, v: (B, Hkv, Lk, D) -> (B, Hq, Lq, D)."""
    Lq, Lk = q.shape[2], k.shape[2]
    for name, n in (("Lq", Lq), ("Lk", Lk)):
        if n and n % min(BLOCK, n):
            raise ValueError(f"{name}={n} must be a multiple of {BLOCK} "
                             f"(or at most {BLOCK})")
    return flash_attention(q, k, v, causal=causal, window=window)


class _AttentionTrainable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            o = mha_ref(q, k, v, causal=ctx.causal, window=ctx.window)
        return (*torch.autograd.grad(o, (q, k, v), g), None, None)


def attention_trainable(q, k, v, causal: bool = True,
                        window: Optional[int] = None):
    """:func:`attention` with gradients: the kernel forward, the backward
    of ``mha_ref`` (q: (B, Hq, L, D); k, v: (B, Hkv, L, D))."""
    return _AttentionTrainable.apply(q, k, v, causal, window)
