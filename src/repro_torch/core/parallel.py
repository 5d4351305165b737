"""Parallel-in-time MAP estimation: the parallel RTS smoother (paper
sections 4.1-4.3, method 1), ``discrete`` element mode.

Pipeline (all reversed-time; results are flipped back to original time):

1. **Element init** (parallel over blocks): exact substep-element
   composition inside each block.
2. **Backward pass**: suffix associative scan with the combine (42) over
   ``[a_0 .. a_{T-1}, a_T]`` -> value functions at all block boundaries
   (the parallel Kalman-Bucy filter, log-span).
3. **Interior fill** (parallel over blocks): information-form steps inside
   each block from its right-boundary value.
4. **Recovery**: per-substep affine maps -> within-block compose -> prefix
   scan with (45)-(46) -> eq. (47).

``suffix_scan_fn`` / ``prefix_scan_fn`` let callers swap the plain scans,
e.g. for the CUDA-kernel scan of ``repro_torch.kernels.lqt_combine``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from . import pscan
from .combine import _mv, _solve_vec, affine_combine, lqt_combine
from .elements import (
    _check_blocks,
    backward_value_fill_discrete,
    discrete_block_elements,
    require_discrete,
    terminal_element,
)
from .sequential import affine_recovery_maps
from .types import AffineElement, GridLQT, LQTElement, MAPSolution, ValueFn


def _append_elem(elems: LQTElement, last: LQTElement) -> LQTElement:
    """Append ``last`` along the scan axis (broadcast over record dims, so
    a prior shared by all records joins per-record blocks)."""
    return LQTElement(*(torch.cat([a, l.expand(a.shape[1:])[None]], dim=0)
                        for a, l in zip(elems, last)))


def parallel_backward(
    grid: GridLQT,
    nsub: int,
    mode: str = "euler",
    combine_fn: Callable = lqt_combine,
    suffix_scan_fn: Optional[Callable] = None,
):
    """Parallel Kalman-Bucy filter (information form).

    Returns ``(values_full, boundary, block_elems, sub_elems)``:
    ``values_full`` holds S(tau_j), v(tau_j) for every substep j = 0..N,
    ``boundary`` the block-boundary values (T+1, ...), ``block_elems`` the
    scan elements and ``sub_elems`` the per-substep elements.
    """
    require_discrete(mode)
    blocks, sub = discrete_block_elements(grid, nsub)

    elems = _append_elem(blocks, terminal_element(grid))
    if suffix_scan_fn is not None:
        sbar = suffix_scan_fn(elems)
    else:
        sbar = pscan.suffix_scan(combine_fn, elems)
    boundary = ValueFn(sbar.J, sbar.eta)                      # (T+1, ...)

    right = ValueFn(boundary.S[1:], boundary.v[1:])           # (T, ...)
    interior = backward_value_fill_discrete(sub, right)       # (T, n, ...)

    # Each block's left point takes the scan-combined boundary value
    # (identical in discrete mode), written in place into the freshly
    # stacked fill, then the blocks flatten to the (N+1) substep grid.
    S_blk, v_blk = interior
    S_blk[:, 0] = boundary.S[:-1]
    v_blk[:, 0] = boundary.v[:-1]
    N = grid.N
    values_full = ValueFn(
        torch.cat([S_blk.reshape((N,) + S_blk.shape[2:]), boundary.S[-1:]]),
        torch.cat([v_blk.reshape((N,) + v_blk.shape[2:]), boundary.v[-1:]]),
    )
    return values_full, boundary, blocks, sub


def _recover_affine(grid: GridLQT, values_full: ValueFn, nsub: int,
                    mode: str,
                    prefix_scan_fn: Optional[Callable] = None):
    """Method 1 (eq. 47): parallel RTS trajectory recovery."""
    Phi, beta = affine_recovery_maps(grid, values_full, mode)
    T = _check_blocks(grid.N, nsub)
    Phi = Phi.reshape((T, nsub) + Phi.shape[1:])
    beta = beta.reshape((T, nsub) + beta.shape[1:])

    # Within-block cumulative compose, all blocks at once.
    cur = AffineElement(Phi[:, 0], beta[:, 0])
    cum = [cur]
    for l in range(1, nsub):
        cur = affine_combine(cur, AffineElement(Phi[:, l], beta[:, l]))
        cum.append(cur)
    cum_Phi = torch.stack([c.Phi for c in cum], dim=1)       # (T, n, ...)
    cum_beta = torch.stack([c.beta for c in cum], dim=1)

    # Global prefix scan over block totals (eqs. 45-46).
    if prefix_scan_fn is not None:
        prefix = prefix_scan_fn(cur)                          # (T, ...)
    else:
        prefix = pscan.prefix_scan(affine_combine, cur)       # (T, ...)

    phi0 = _solve_vec(values_full.S[0], values_full.v[0])     # (*R, nx)
    bound = _mv(prefix.Phi, phi0) + prefix.beta
    starts = torch.cat([phi0[None], bound[:-1]], dim=0)       # (T, *R, nx)

    # phi at tau_{i*n + l + 1} = cum[i, l] applied to starts[i].
    sub = _mv(cum_Phi, starts[:, None]) + cum_beta
    return torch.cat([phi0[None], sub.reshape((grid.N,) + sub.shape[2:])])


def parallel_rts(
    grid: GridLQT, nsub: int, mode: str = "euler",
    combine_fn: Callable = lqt_combine,
    suffix_scan_fn: Optional[Callable] = None,
    prefix_scan_fn: Optional[Callable] = None,
) -> MAPSolution:
    """Parallel continuous-time RTS smoother (sections 4.1-4.3, method 1).

    ``suffix_scan_fn`` (elems -> inclusive suffix combine) replaces the
    plain scan of the backward pass; the ``parallel_kernel`` method passes
    :func:`repro_torch.kernels.lqt_combine.ops.kernel_suffix_scan` here.
    ``prefix_scan_fn`` does the same for the affine recovery scan.
    """
    values_full, _, _, _ = parallel_backward(
        grid, nsub, mode, combine_fn=combine_fn,
        suffix_scan_fn=suffix_scan_fn)
    phi = _recover_affine(grid, values_full, nsub, mode,
                          prefix_scan_fn=prefix_scan_fn)
    return MAPSolution(
        x=torch.flip(phi, (0,)),
        S=torch.flip(values_full.S, (0,)),
        v=torch.flip(values_full.v, (0,)))
