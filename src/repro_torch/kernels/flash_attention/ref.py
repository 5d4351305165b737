"""Plain PyTorch version of the flash-attention kernel: causal (optionally
sliding-window) GQA attention with the full logit matrix.

The CPU path of the kernel wrapper, and what ``chip_smoke.py`` holds the
CUDA kernel against on the card.  It repeats the reference oracle
``repro/kernels/flash_attention/ref.py::mha_ref``: logits in the inputs'
dtype, then float32 softmax, probabilities cast back before the PV product.
"""
from __future__ import annotations

import torch


def mha_ref(q, k, v, *, causal: bool = True, window: int | None = None,
            scale: float | None = None):
    """Reference attention.

    Args:
      q: (B, Hq, Lq, D)
      k, v: (B, Hkv, Lk, D) with Hq % Hkv == 0 (GQA)
      causal: apply the causal mask (q rows aligned to the end of the keys)
      window: sliding-window size (positions attend to the previous
        ``window-1`` positions and themselves)
      scale: logit scale; defaults to D**-0.5
    Returns:
      (B, Hq, Lq, D) in q's dtype
    """
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    kk = torch.repeat_interleave(k, rep, dim=1)
    vv = torch.repeat_interleave(v, rep, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, kk).float() * scale
    if causal or window is not None:
        iq = torch.arange(Lq, device=q.device)[:, None] + (Lk - Lq)
        jk = torch.arange(Lk, device=q.device)[None, :]
        mask = torch.ones((Lq, Lk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= iq >= jk
        if window is not None:
            mask &= (iq - jk) < window
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(q.dtype), vv)
