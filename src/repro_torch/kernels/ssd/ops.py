"""SSD op over the chunked-SSD kernel.

Handles what the kernel does not: the batch/head flattening and the
group -> head broadcast (``_prep``), padding of the sequence to a multiple
of the chunk size, and the ``D`` skip connection.  The casts are the
reference's (``repro/kernels/ssd/ops.py``): ``l = dt * A`` in float32
(A is float32), ``dtx = dt * x`` and B, C in the inputs' dtype, the
kernel's y in dtx's dtype, and the skip added in that dtype.  The
trainable variant (``ssd_trainable``, a ``custom_vjp`` in the reference)
waits for the training slice (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import torch.nn.functional as F

from .kernel import ssd_chunked


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
