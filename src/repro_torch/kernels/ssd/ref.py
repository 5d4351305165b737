"""Plain PyTorch versions of the chunked SSD (state-space dual) scan.

The SSD recurrence is the paper's affine trajectory recursion (eqs.
45-46) with a diagonal (scalar-per-head) transition:

    h_t = exp(dt_t A_h) h_{t-1} + dt_t x_t (x) B_t        (Phi, beta)
    y_t = h_t C_t^T  (+ D_h x_t)

* :func:`ssd_ref` -- the sequential oracle (the reference's
  ``repro/kernels/ssd/ref.py::ssd_ref``): exact, O(L) steps.
* :func:`ssd_chunked_ref` -- the kernel's plain version: the arithmetic
  and casts of the reference's ``_ssd_kernel`` chunk by chunk, on the
  kernel's operands ``(l, dtx, B, C)``.  The CPU path of the kernel
  wrapper, and what ``chip_smoke.py`` holds the CUDA kernels against.
* :func:`ssd_staged_ref` -- the same function in the three stages of the
  chunk-parallel kernel (``csrc/ssd_mma.cu``), with the entering chunk
  states, and optionally the kernel's bf16 hi/lo split of its float32
  operands (:func:`bf16_split`).
* :func:`ssd_scan_chunked` -- the model's plain SSD (the reference's
  ``models/ssm.py::ssd_scan_jnp``): the skip connection included, chunk
  elements folded by an associative scan.  The plain path of
  ``models/ssm.py`` and what ``ops.ssd_trainable`` differentiates.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.pscan import prefix_scan


def ssd_ref(x, dt, A, B, C, D=None):
    """Sequential SSD scan.

    Args:
      x:  (batch, L, H, P)
      dt: (batch, L, H)      positive step sizes (already softplus'ed)
      A:  (H,)               negative per-head decay rates
      B:  (batch, L, G, S)   input projections (G groups, H % G == 0)
      C:  (batch, L, G, S)   output projections
      D:  optional (H,)      skip connection
    Returns:
      y: (batch, L, H, P) in x's dtype
    """
    b, L, H, P = x.shape
    G, S = B.shape[2], B.shape[3]
    rep = H // G
    Bh = torch.repeat_interleave(B, rep, dim=2)       # (b, L, H, S)
    Ch = torch.repeat_interleave(C, rep, dim=2)
    acc = torch.promote_types(x.dtype, torch.float32)
    h = torch.zeros((b, H, P, S), dtype=acc, device=x.device)
    ys = []
    for t in range(L):
        a = torch.exp(dt[:, t] * A)                   # (b, H)
        h = (a[..., None, None] * h
             + (dt[:, t, :, None] * x[:, t])[..., None] * Bh[:, t, :, None, :])
        ys.append(torch.einsum("bhps,bhs->bhp", h, Ch[:, t].to(h.dtype)))
    y = torch.stack(ys, dim=1).to(x.dtype)
    if D is not None:
        y = y + D[None, None, :, None] * x
    return y


def ssd_chunked_ref(l, dtx, B, C, *, chunk: int):
    """Chunked SSD scan on the kernel's operands.

    Args:
      l:   (BH, L) float32   log decays dt*A (<= 0)
      dtx: (BH, L, P)        dt-weighted inputs
      B:   (BH, L, S)
      C:   (BH, L, S)        (dtx, B, C of one dtype; L % chunk == 0)
    Returns:
      y: (BH, L, P) in dtx's dtype
    """
    BH, L, P = dtx.shape
    S = B.shape[-1]
    f32 = torch.float32
    state = torch.zeros((BH, P, S), dtype=f32, device=dtx.device)
    ids = torch.arange(chunk, device=dtx.device)
    causal = ids[:, None] >= ids[None, :]
    ys = []
    for c0 in range(0, L, chunk):
        sl = slice(c0, c0 + chunk)
        lc = l[:, sl].to(f32)
        dtxc, Bc, Cc = (a[:, sl].to(f32) for a in (dtx, B, C))
        cum = torch.cumsum(lc, dim=1)                  # (BH, Q)
        total = cum[:, -1]
        # inter-chunk contribution: y_t += exp(cum_t) * C_t . state
        y_inter = torch.exp(cum)[..., None] * torch.einsum(
            "bqs,bps->bqp", Cc, state)
        # intra-chunk: masked decay kernel M[t,s] = exp(cum_t - cum_s)[s<=t]
        M = torch.where(causal, torch.exp(cum[:, :, None] - cum[:, None, :]),
                        torch.zeros((), dtype=f32, device=dtx.device))
        G = torch.einsum("bts,bks->btk", Cc, Bc)
        y_intra = torch.einsum("btk,bkp->btp", M * G, dtxc)
        ys.append((y_inter + y_intra).to(dtx.dtype))
        # element fold (eqs. 45-46, diagonal Phi)
        w = torch.exp(total[:, None] - cum)[..., None] * dtxc
        inc = torch.einsum("btp,bts->bps", w, Bc)
        state = torch.exp(total)[:, None, None] * state + inc
    return torch.cat(ys, dim=1)


def bf16_split(x):
    """``(hi, lo)`` in bfloat16 with ``hi + lo`` equal to float32 ``x`` to
    2^-16 relative: ``hi = bf16(x)``, ``lo = bf16(x - hi)`` (the difference
    is exact in float32).  The chunk-parallel kernel feeds its float32
    operands to the bf16 tensor cores this way."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def ssd_staged_ref(l, dtx, B, C, *, chunk: int, split_bf16: bool = False):
    """Chunked SSD scan in the three stages of the chunk-parallel kernel.

    1. per chunk: ``total`` and ``inc = (exp(total - cum) * dtx)^T B``;
    2. over chunks: ``state_c = exp(total_{c-1}) state_{c-1} + inc_{c-1}``,
       ``state_0 = 0``;
    3. per chunk: ``y = exp(cum) * (C state_c^T) + (M o C B^T) dtx``.

    Arithmetic is float32 on the operands' values.  With ``split_bf16``
    the three float32 operands of the kernel's products (``exp(total -
    cum) * dtx``, ``state``, ``M o C B^T``) are split by :func:`bf16_split`
    and the two products summed, as the kernel does.

    Args as :func:`ssd_chunked_ref`.  Returns ``(y, states)``: y (BH, L, P)
    in dtx's dtype and the float32 entering states (BH, L/chunk, P, S).
    """
    BH, L, P = dtx.shape
    S = B.shape[-1]
    nc = L // chunk
    f32 = torch.float32

    def mm(eq, a, b):          # a: the float32 operand the kernel splits
        if not split_bf16:
            return torch.einsum(eq, a, b)
        hi, lo = bf16_split(a)
        return torch.einsum(eq, hi.to(f32), b) + torch.einsum(eq, lo.to(f32),
                                                              b)

    cum = torch.cumsum(l.to(f32).reshape(BH, nc, chunk), dim=-1)
    total = cum[..., -1]                                    # (BH, nc)
    x, Bc, Cc = (a.to(f32).reshape(BH, nc, chunk, -1) for a in (dtx, B, C))
    # 1. chunk elements
    w = torch.exp(total[..., None] - cum)[..., None] * x
    inc = mm("bctp,bcts->bcps", w, Bc)
    # 2. exclusive scan over chunks
    states = torch.empty((BH, nc, P, S), dtype=f32, device=dtx.device)
    state = torch.zeros((BH, P, S), dtype=f32, device=dtx.device)
    for c in range(nc):
        states[:, c] = state
        state = torch.exp(total[:, c])[:, None, None] * state + inc[:, c]
    # 3. chunk outputs
    y_inter = torch.exp(cum)[..., None] * mm("bcps,bcts->bctp", states, Cc)
    ids = torch.arange(chunk, device=dtx.device)
    M = torch.where(ids[:, None] >= ids[None, :],
                    torch.exp(cum[..., :, None] - cum[..., None, :]),
                    torch.zeros((), dtype=f32, device=dtx.device))
    G = torch.einsum("bcts,bcks->bctk", Cc, Bc)
    y_intra = mm("bctk,bckp->bctp", M * G, x)
    y = (y_inter + y_intra).to(dtx.dtype).reshape(BH, L, P)
    return y, states


def ssd_scan_chunked(x, dt, A, B, C, D, chunk: int):
    """Chunked SSD in float32: the paper's block-element + scan pattern.

    Stage 1 builds per-chunk elements, stage 2 folds them with an
    associative prefix scan (eqs. 45-46, diagonal Phi), stage 3 emits the
    per-chunk outputs one chunk at a time (the (Q, Q, H) decay tensor
    exists for one chunk only).

    x: (b, L, H, P); dt: (b, L, H); A: (H,); B, C: (b, L, G, S); D: (H,).
    """
    b, L0, H, Pd = x.shape
    G, S = B.shape[2], B.shape[3]
    rep = H // G
    Q = min(chunk, L0)
    pad = (-L0) % Q
    if pad:  # dt=0 padding steps are exact identity elements
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    L = L0 + pad
    nc = L // Q

    f32 = torch.float32
    l = dt.float() * A.float()[None, None, :]                 # (b, L, H)
    dtx = dt.float()[..., None] * x.float()                   # (b, L, H, P)

    # chunk-major views (chunk axis first for the scan)
    lc = l.reshape(b, nc, Q, H).movedim(1, 0)                 # (nc,b,Q,H)
    cum = torch.cumsum(lc, dim=2)
    total = cum[:, :, -1]                                     # (nc,b,H)
    dtxc = dtx.reshape(b, nc, Q, H, Pd).movedim(1, 0)
    Bc = B.float().reshape(b, nc, Q, G, S).movedim(1, 0)
    Cc = C.float().reshape(b, nc, Q, G, S).movedim(1, 0)

    # stage 1 -- per-chunk elements (parallel over chunks):
    w = torch.exp(total[:, :, None] - cum)[..., None] * dtxc  # (nc,b,Q,H,P)
    wg = w.reshape(nc, b, Q, G, rep, Pd)
    inc = torch.einsum("nbqgrp,nbqgs->nbgrps", wg, Bc)
    inc = inc.reshape(nc, b, H, Pd, S)                        # (nc,b,H,P,S)

    # stage 2 -- associative inter-chunk scan (paper eqs. 45-46):
    def combine(e1, e2):
        t1, i1 = e1
        t2, i2 = e2
        return (t1 + t2, torch.exp(t2)[..., None, None] * i1 + i2)

    _, inc_in = prefix_scan(combine, (total, inc))
    # exclusive prefix: state entering chunk c
    h_prev = torch.cat(
        [torch.zeros((1, b, H, Pd, S), dtype=f32, device=x.device),
         inc_in[:-1]], dim=0)

    # stage 3 -- per-chunk outputs, one chunk in flight at a time:
    ids = torch.arange(Q, device=x.device)
    causal = ids[:, None] >= ids[None, :]
    ys = []
    for c in range(nc):
        cumc, dtxk, Bk, Ck, hk = cum[c], dtxc[c], Bc[c], Cc[c], h_prev[c]
        # inter: y_t = exp(cum_t) * C_t . h_prev
        hg = hk.reshape(b, G, rep, Pd, S)
        y_inter = torch.einsum("bqgs,bgrps->bqgrp", Ck, hg)
        y_inter = y_inter * torch.exp(cumc).reshape(b, Q, G, rep, 1)
        # intra: masked decay kernel
        Gmat = torch.einsum("bqgs,bkgs->bgqk", Ck, Bk)        # (b,G,Q,Q)
        # masked before exp: above the diagonal cum_t - cum_s >= 0 can
        # overflow, and exp's gradient there would be 0 * inf = nan
        dec = torch.exp(torch.where(
            causal[None, :, :, None],
            cumc[:, :, None, :] - cumc[:, None, :, :],
            torch.full((), float("-inf"), dtype=f32, device=x.device)))
        decg = dec.reshape(b, Q, Q, G, rep)
        M = Gmat.permute(0, 2, 3, 1)[..., None] * decg        # (b,Q,Q,G,rep)
        dtxg = dtxk.reshape(b, Q, G, rep, Pd)
        y_intra = torch.einsum("bqkgr,bkgrp->bqgrp", M, dtxg)
        ys.append((y_inter + y_intra).reshape(b, Q, H, Pd))
    y = torch.stack(ys, dim=1).reshape(b, L, H, Pd)
    y = y + D.float()[None, None, :, None] * x.float()
    return y[:, :L0].to(x.dtype)
