"""Parallel-in-time MAP estimation (the paper's contribution, sections
3-4).

Pipeline (all reversed-time; results are flipped back to original time):

1. **Element init** (parallel over blocks): eq. (43) Euler/rk4 integration
   (``euler``/``rk4`` modes) or exact substep-element composition
   (``discrete``).
2. **Backward pass**: suffix associative scan with the combine (42) over
   ``[a_0 .. a_{T-1}, a_T]`` -> value functions at all block boundaries
   (the parallel Kalman-Bucy filter, log-span).
3. **Interior fill** (parallel over blocks): backward HJB/(15) within each
   block from its right-boundary value.
4. **Recovery**:
   * method 1 (parallel RTS smoother, section 4.3): per-substep affine
     maps -> within-block compose -> prefix scan with (45)-(46) -> eq. (47);
   * method 2 (parallel two-filter smoother): prefix scan of
     ``[e (x) a_0, a_1, ...]`` (eqs. 49-50) -> eq. (48), forward interior
     fill, plus smoothing covariances.

``suffix_scan_fn`` / ``prefix_scan_fn`` let callers of the RTS smoother
swap the plain scans, e.g. for the CUDA-kernel scan of
``repro_torch.kernels.lqt_combine``.  The two-filter smoother has no such
hook, as in the reference: it runs the plain combine.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.obs.tracing import trace_range

from . import pscan
from .combine import (
    _mv,
    _solve_vec,
    affine_combine,
    elem_min_initial,
    lqt_combine,
)
from .elements import (
    CORE_STEPS,
    InBlockSteps,
    _check_blocks,
    backward_value_fill_discrete,
    backward_value_fill_euler,
    discrete_block_elements,
    euler_block_elements,
    forward_value_fill_discrete,
    forward_value_fill_euler,
    identity_element,
    one_step_elements,
    terminal_element,
)
from .sequential import _run_affine, affine_recovery_maps, two_filter_combine
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
    steps: InBlockSteps = CORE_STEPS,
):
    """Parallel Kalman-Bucy filter (information form).

    Returns ``(values_full, boundary, block_elems, sub_elems)``:
    ``values_full`` holds S(tau_j), v(tau_j) for every substep j = 0..N,
    ``boundary`` the block-boundary values (T+1, ...), ``block_elems`` the
    scan elements and ``sub_elems`` the per-substep elements (``discrete``
    mode only, else None).  ``steps`` folds each block's substep elements
    and steps the values inside each block in ``discrete`` mode.
    """
    with trace_range("solve.elements"):
        if mode == "discrete":
            blocks, sub = discrete_block_elements(grid, nsub, steps)
        elif mode in ("euler", "rk4"):
            blocks = euler_block_elements(grid, nsub, integrator=mode)
            sub = None
        else:
            raise ValueError(f"unknown element mode: {mode}")
        elems = _append_elem(blocks, terminal_element(grid))
    with trace_range("solve.scan"):
        if suffix_scan_fn is not None:
            sbar = suffix_scan_fn(elems)
        else:
            sbar = pscan.suffix_scan(combine_fn, elems)
    boundary = ValueFn(sbar.J, sbar.eta)                      # (T+1, ...)

    with trace_range("solve.fill"):
        right = ValueFn(boundary.S[1:], boundary.v[1:])       # (T, ...)
        if mode == "discrete":
            interior = backward_value_fill_discrete(      # (T, n, ...)
                sub, right, steps)
        else:
            interior = backward_value_fill_euler(grid, nsub, right,
                                                 integrator=mode)

        # Each block's left point takes the scan-combined boundary value
        # (identical in discrete mode; the parallel-consistent choice in
        # euler mode), written in place into the freshly stacked fill,
        # then the blocks flatten to the (N+1) substep grid.
        S_blk, v_blk = interior
        S_blk[:, 0] = boundary.S[:-1]
        v_blk[:, 0] = boundary.v[:-1]
        N = grid.N
        values_full = ValueFn(
            torch.cat([S_blk.reshape((N,) + S_blk.shape[2:]),
                       boundary.S[-1:]]),
            torch.cat([v_blk.reshape((N,) + v_blk.shape[2:]),
                       boundary.v[-1:]]),
        )
    return values_full, boundary, blocks, sub


def _recover_affine(grid: GridLQT, values_full: ValueFn, nsub: int,
                    mode: str,
                    prefix_scan_fn: Optional[Callable] = None,
                    steps: InBlockSteps = CORE_STEPS):
    """Method 1 (eq. 47): parallel RTS trajectory recovery."""
    Phi, beta = affine_recovery_maps(grid, values_full, mode, steps)
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
    steps: InBlockSteps = CORE_STEPS,
) -> MAPSolution:
    """Parallel continuous-time RTS smoother (sections 4.1-4.3, method 1).

    ``suffix_scan_fn`` (elems -> inclusive suffix combine) replaces the
    plain scan of the backward pass; the ``parallel_kernel`` method passes
    :func:`repro_torch.kernels.lqt_combine.ops.kernel_suffix_scan` here.
    ``prefix_scan_fn`` does the same for the affine recovery scan, and
    ``steps`` (:class:`~repro_torch.core.elements.InBlockSteps`) for the
    in-block folds, value steps and recovery maps of ``discrete`` mode.
    """
    values_full, _, _, _ = parallel_backward(
        grid, nsub, mode, combine_fn=combine_fn,
        suffix_scan_fn=suffix_scan_fn, steps=steps)
    with trace_range("solve.recover"):
        phi = _recover_affine(grid, values_full, nsub, mode,
                              prefix_scan_fn=prefix_scan_fn, steps=steps)
        return MAPSolution(
            x=torch.flip(phi, (0,)),
            S=torch.flip(values_full.S, (0,)),
            v=torch.flip(values_full.v, (0,)))


def _grid_slice(grid: GridLQT, sl: slice) -> GridLQT:
    """The substeps ``sl`` of a grid (the terminal prior is kept)."""
    return grid._replace(**{
        f: None if getattr(grid, f) is None else getattr(grid, f)[sl]
        for f in ("dt", "F", "c", "H", "r", "Q", "Rinv", "y", "lin")})


def parallel_two_filter(
    grid: GridLQT, nsub: int, mode: str = "euler",
    combine_fn: Callable = lqt_combine,
    jitter: float = 1e-9,
    block0_fill: str = "affine",
    tf_fill: str = "combine",
) -> MAPSolution:
    """Parallel continuous-time two-filter smoother (section 4.3, method 2).

    ``block0_fill`` selects the interior recovery inside the first block,
    where the forward value function has not yet accumulated invertible
    information: ``"affine"`` (default) propagates the exact optimal
    trajectory maps from phi*(tau_0) (no jitter); ``"min_initial"`` follows
    eq. (39) with jitter-regularised eq. (50) pointwise.  Covariances
    inside block 0 are only available with ``"min_initial"`` (NaN
    otherwise); boundary and later-block covariances are always exact.

    ``tf_fill`` selects the interior fill for blocks >= 1 in ``euler``/
    ``rk4`` mode: ``"combine"`` (default) composes closed-form one-substep
    elements exactly; ``"hjb_euler"`` is the paper-literal explicit Euler
    on the forward HJB ODEs (51), stiff when C H^T R^{-1} H dt approaches
    1.  ``discrete`` mode always uses exact combines.
    """
    if block0_fill not in ("affine", "min_initial"):
        raise ValueError(f"unknown block0_fill: {block0_fill}")
    if mode != "discrete" and tf_fill not in ("combine", "hjb_euler"):
        raise ValueError(f"unknown tf_fill: {tf_fill}")
    values_full, boundary, blocks, sub = parallel_backward(
        grid, nsub, mode, combine_fn=combine_fn)
    T = _check_blocks(grid.N, nsub)
    lead = tuple(grid.F.shape[1:-2])              # record dims

    # Forward prefix scan of [e (x) a_0, a_1, ..., a_{T-1}]  (eqs. 49-50).
    a0bar = elem_min_initial(LQTElement(*(a[0] for a in blocks)),
                             jitter=jitter)
    fwd_elems = LQTElement(*(torch.cat([f[None], a[1:]])
                             for f, a in zip(a0bar, blocks)))
    fwd = pscan.prefix_scan(combine_fn, fwd_elems)            # (T, ...)

    # Block-boundary states via eq. (48).
    phi_b, cov_b = two_filter_combine(fwd, boundary.S[1:], boundary.v[1:])
    phi0 = _solve_vec(boundary.S[0], boundary.v[0])
    cov0 = torch.linalg.inv(boundary.S[0])

    # Interior fill for blocks 1..T-1 from fwd[i-1]: (T-1, n, ...) at the
    # right points tau_{i*n + l + 1}.
    left = LQTElement(*(a[:-1] for a in fwd))
    if mode == "discrete":
        fill = forward_value_fill_discrete(
            LQTElement(*(a[1:] for a in sub)), left)
    elif tf_fill == "combine":
        sub_all = LQTElement(*(a.reshape((T, nsub) + a.shape[1:])
                               for a in one_step_elements(grid)))
        fill = forward_value_fill_discrete(
            LQTElement(*(a[1:] for a in sub_all)), left)
    else:
        fill = forward_value_fill_euler(
            _grid_slice(grid, slice(nsub, None)), nsub, left)
    flat = LQTElement(*(a.reshape((grid.N - nsub,) + a.shape[2:])
                        for a in fill))
    phi_tail, cov_tail = two_filter_combine(
        flat, values_full.S[nsub + 1:], values_full.v[nsub + 1:])
    # parallel-consistent block boundaries: overwrite the l = n-1 entries
    phi_tail = phi_tail.reshape((T - 1, nsub) + phi_tail.shape[1:])
    cov_tail = cov_tail.reshape((T - 1, nsub) + cov_tail.shape[1:])
    phi_tail[:, -1] = phi_b[1:]
    cov_tail[:, -1] = cov_b[1:]
    phi_tail = phi_tail.reshape((grid.N - nsub,) + phi_tail.shape[2:])
    cov_tail = cov_tail.reshape((grid.N - nsub,) + cov_tail.shape[2:])

    # Block-0 interior (tau_1 .. tau_{n-1}) + its right boundary tau_n.
    head = _grid_slice(grid, slice(0, nsub))
    if block0_fill == "affine":
        Phi, beta = affine_recovery_maps(
            head, ValueFn(values_full.S[:nsub + 1], values_full.v[:nsub + 1]),
            mode)
        phi_blk0 = _run_affine(phi0, Phi, beta)[1:]           # (n, ...)
        cov_blk0 = torch.full((nsub,) + cov_b.shape[1:], float("nan"),
                              dtype=cov_b.dtype, device=cov_b.device)
    else:
        nx = grid.nx
        e_id = identity_element(nx, grid.F.dtype, grid.F.device)
        left0 = LQTElement(*(a.expand((1,) + lead + a.shape)
                             for a in e_id))
        if mode == "discrete":
            f0 = forward_value_fill_discrete(
                LQTElement(*(a[:1] for a in sub)), left0)
        else:
            f0 = forward_value_fill_euler(head, nsub, left0)
        folded = elem_min_initial(LQTElement(*(a[0] for a in f0)),
                                  jitter=jitter)
        phi_blk0, cov_blk0 = two_filter_combine(
            folded, values_full.S[1:nsub + 1], values_full.v[1:nsub + 1])
    phi_blk0[-1] = phi_b[0]
    cov_blk0[-1] = cov_b[0]

    phi = torch.cat([phi0[None], phi_blk0, phi_tail], dim=0)
    cov = torch.cat([cov0[None], cov_blk0, cov_tail], dim=0)
    return MAPSolution(
        x=torch.flip(phi, (0,)),
        S=torch.flip(values_full.S, (0,)),
        v=torch.flip(values_full.v, (0,)),
        cov=torch.flip(cov, (0,)))
