"""SSD ops over the chunked-SSD kernel.

Handles what the kernel does not: the batch/head flattening and the
group -> head broadcast (``_prep``), padding of the sequence to a multiple
of the chunk size, and the ``D`` skip connection.  The casts are the
reference's (``repro/kernels/ssd/ops.py``): ``l = dt * A`` in float32
(A is float32), ``dtx = dt * x`` and B, C in the inputs' dtype, the
kernel's y in dtx's dtype, and the skip added in that dtype.

``ssd_trainable`` is the reference's ``custom_vjp`` as a
``torch.autograd.Function``: the forward pass is :func:`ssd` (the kernel),
the backward pass is autograd through a plain form of the same function,
recomputed from the six saved inputs.  The reference differentiates its
sequential ``ssd_ref``, a ``lax.scan`` that XLA compiles; the port's
``ref.ssd_ref`` is a Python loop of L steps, whose autograd graph at a
training shape (L = 2048) would run millions of eager kernels per step.
So the port differentiates ``ref.ssd_scan_chunked`` instead: the same
function in the same float32 arithmetic in L / chunk chunks, and what the
reference differentiates on its plain training path (``use_kernel=False``,
``ssd_scan_jnp``).  The gradients agree with the reference's to float32
round-off (ROADMAP.md, queue 3).  There is no backward kernel, in the
reference either.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernel import ssd_chunked
from .ref import ssd_scan_chunked


def _prep(x, dt, A, B, C):
    b, L, H, P = x.shape
    G, S = B.shape[2], B.shape[3]
    rep = H // G
    l = (dt * A[None, None, :]).transpose(1, 2).reshape(b * H, L)
    dtx = (dt[..., None] * x).transpose(1, 2).reshape(b * H, L, P)
    Bh = B.repeat_interleave(rep, dim=2).transpose(1, 2).reshape(b * H, L, S)
    Ch = C.repeat_interleave(rep, dim=2).transpose(1, 2).reshape(b * H, L, S)
    return l, dtx, Bh, Ch


def ssd(x, dt, A, B, C, D=None, *, chunk: int = 128):
    """Chunked SSD forward (see ``ref.ssd_ref`` for the semantics).

    x: (b, L, H, P); dt: (b, L, H); A: (H,); B, C: (b, L, G, S); D: (H,).
    """
    b, L, H, P = x.shape
    pad = (-L) % chunk
    if pad:   # dt = 0 steps are exact identity elements
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    l, dtx, Bh, Ch = (a.contiguous() for a in _prep(x, dt, A, B, C))
    y = ssd_chunked(l, dtx, Bh, Ch, chunk=chunk)
    y = y.reshape(b, H, L + pad, P).transpose(1, 2)[:, :L]
    if D is not None:
        y = y + D[None, None, :, None] * x[:, :L]
    return y


class _SSDTrainable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, chunk):
        ctx.save_for_backward(x, dt, A, B, C, D)
        ctx.chunk = chunk
        return ssd(x, dt, A, B, C, D, chunk=chunk)

    @staticmethod
    def backward(ctx, g):
        ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = ssd_scan_chunked(*ins, ctx.chunk)
        return (*torch.autograd.grad(y, ins, g), None)


def ssd_trainable(x, dt, A, B, C, D, chunk: int = 128):
    """:func:`ssd` with gradients for all six inputs, each in its input's
    dtype: the kernel forward, the backward of ``ref.ssd_scan_chunked``.
    ``A`` is float32 (``-exp(A_log.float())``)."""
    return _SSDTrainable.apply(x, dt, A, B, C, D, chunk)
