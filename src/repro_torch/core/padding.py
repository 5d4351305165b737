"""Pad-and-bucket utilities for ragged record lengths.

Records of unequal length are padded to a small set of bucket lengths, so
that each bucket is one stacked solve (one scan launch for
``parallel_kernel``) whatever the mix of lengths.  Padding is EXACT, not
approximate: a padded tail beyond ``t_f`` carries ``measurement_mask = 0``
so it contributes no measurement cost, and the dynamics cost of the tail
is zero at the optimum (the extension follows the drift), hence the MAP
estimate restricted to the real window is unchanged (see
:func:`repro_torch.core.sde.build_grid_lqt`).

Used by :meth:`repro_torch.core.Estimator.solve` on ragged
:class:`~repro_torch.core.Problem`\\ s.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .types import MAPSolution, Solution


def _tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    return torch.as_tensor(np.array(a))


def next_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def bucket_length(
    N: int, nsub: int, bucket_sizes: Optional[Sequence[int]] = None,
) -> int:
    """Padded interval count for a record of ``N`` intervals.

    Default rule: the smallest power-of-two number of ``nsub``-substep
    blocks that fits, i.e. ``nsub * 2^ceil(log2(N / nsub))`` -- always a
    multiple of ``nsub`` (required by the parallel methods' blocking) and
    at most ~2x overhead.  Explicit ``bucket_sizes`` (multiples of
    ``nsub``) override the rule; the smallest fitting bucket is used.
    """
    if bucket_sizes is not None:
        for size in bucket_sizes:
            if size % nsub:
                raise ValueError(
                    f"bucket size {size} not a multiple of nsub={nsub}")
        fitting = [s for s in bucket_sizes if s >= N]
        if not fitting:
            raise ValueError(
                f"record length {N} exceeds largest bucket "
                f"{max(bucket_sizes)}")
        return min(fitting)
    blocks = -(-N // nsub)          # ceil
    return nsub * next_pow2(blocks)


def pad_record(ts, y, n_pad: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pad one record to ``n_pad`` intervals, on the record's device
    (numpy inputs become CPU tensors).

    The time grid is extended past ``t_f`` with the final step size, padded
    measurements are zeros, and the returned mask marks them as carrying no
    information.  Returns ``(ts_pad (n_pad+1,), y_pad (n_pad, ny),
    mask (n_pad,))``.
    """
    ts, y = _tensor(ts), _tensor(y)
    N = y.shape[0]
    if N < 1:
        raise ValueError("record must have at least one interval")
    if ts.shape[0] != N + 1:
        raise ValueError(f"ts has {ts.shape[0]} points for {N} intervals")
    if n_pad < N:
        raise ValueError(f"n_pad={n_pad} < record length {N}")
    if not bool((ts[1:] > ts[:-1]).all()):
        # the padded grid extrapolates with dt_last = ts[-1] - ts[-2]; a
        # non-increasing grid would silently produce a broken (reversed /
        # zero-step) padded tail, so fail loudly here instead.
        raise ValueError(
            "ts must be strictly increasing to pad (the padded grid "
            f"extends past t_f with the final step size); got ts={ts!r}")
    extra = n_pad - N
    dt_last = ts[-1] - ts[-2]
    steps = torch.arange(1, extra + 1, dtype=ts.dtype, device=ts.device)
    ts_pad = torch.cat([ts, ts[-1] + dt_last * steps])
    y_pad = torch.cat([y, y.new_zeros((extra,) + tuple(y.shape[1:]))])
    mask = torch.cat([y.new_ones(N), y.new_zeros(extra)])
    return ts_pad, y_pad, mask


def slice_solution(
    sol: Union[Solution, MAPSolution], row: int, N: int,
) -> Union[Solution, MAPSolution]:
    """Extract record ``row`` from a batched solution, un-padded to ``N``
    intervals (``N+1`` trajectory points).

    A :class:`~repro_torch.core.types.Solution` carries the record axis
    first (``x`` ``(B, N+1, nx)``); a
    :class:`~repro_torch.core.types.MAPSolution` carries time first and
    the record axis second (``x`` ``(N+1, B, nx)``), the port's solver
    layout.  Time-indexed fields (``x``/``S``/``v``/``cov``) are sliced;
    per-record diagnostics of a ``Solution`` (``cost``, ``cost_trace``,
    ``step_norms``) keep the whole row.
    """
    if isinstance(sol, Solution):
        take = lambda a: None if a is None else a[row, :N + 1]
        per_record = lambda a: None if a is None else a[row]
        return Solution(
            x=take(sol.x), S=take(sol.S), v=take(sol.v), cov=take(sol.cov),
            cost=per_record(sol.cost),
            cost_trace=per_record(sol.cost_trace),
            step_norms=per_record(sol.step_norms),
            padding=sol.padding)
    take = lambda a: None if a is None else a[:N + 1, row]
    return MAPSolution(x=take(sol.x), S=take(sol.S), v=take(sol.v),
                       cov=take(sol.cov))
