"""Shared wave machinery for the estimation serving engines.

Both engines -- :class:`~repro_torch.serving.TrajectoryEngine` (whole
offline records) and :class:`~repro_torch.serving.StreamingEngine`
(fixed-lag sliding windows) -- batch work the same way: FIFO waves of
exactly ``batch`` rows grouped by padded bucket length, short waves topped
up by recycling a live row, padded rows masked exactly (see
:mod:`repro_torch.core.padding`).  The counterpart of the reference's
``repro/serving/waves.py``:

* :class:`WaveItem` -- one queued unit of work (a record or a window
  snapshot), optionally carrying a warm-start trajectory and an
  information-form prior for its left boundary;
* :func:`validate_record` -- shared submit-time shape + time-grid checks;
* :func:`merge_measurements` / :func:`insert_warm_states` -- time-ordered
  merge of a late/out-of-order measurement batch into an existing window
  series, and the matching warm-start-trajectory fix-up;
* :func:`take_wave` -- FIFO wave selection: the oldest item fixes the
  bucket (and whether rows carry warm starts and priors), later items of
  that kind top the wave up (continuous batching);
* :func:`pack_wave` -- pad + stack a wave into the tensors of one
  ``Problem.stacked`` solve;
* :func:`record_wave_metrics` -- the per-wave obs readout under a metric
  prefix (``engine.*`` / ``stream.*``).

Merging, validation, selection and padding stay on the host in numpy
and CPU tensors; :func:`pack_wave` then makes ONE host-to-device copy per
stacked array of the wave.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.padding import pad_record
from repro_torch.core.registry import get_method


def robust_default_options(method: str):
    """The serving engines' default solver options: the method's defaults
    with the ``discrete`` element mode.

    The :class:`~repro_torch.core.Estimator` defaults to the paper's
    ``euler`` element mode, which is explicit-Euler-unstable once a
    block's information Riccati gets stiff (small R / large ``nsub * dt``):
    block elements overflow and the estimate turns NaN (the Wiener-velocity
    model at dt = 0.1 from 4 blocks of ``nsub=10`` up).  A serving engine
    cannot pick its record lengths, so it defaults to the ``discrete``
    mode (exact substep composition, unconditionally stable) and leaves
    ``euler`` opt-in via ``options=``.

    Iterated nonlinear methods (``"sigma_point"``) take the ``discrete``
    mode on their INNER method's options; the outer options keep their own
    defaults (iterations, linearisation family).
    """
    spec = get_method(method)
    if spec.nonlinear:
        outer = spec.options_cls()
        inner = get_method(outer.inner_method).options_cls(mode="discrete")
        return outer.replace(inner=inner)
    return spec.options_cls(mode="discrete")


@dataclasses.dataclass
class WaveItem:
    """One queued unit of work: a whole record or one window snapshot.

    ``key`` is the caller's handle (ticket / track id).  ``ts``/``y`` are
    numpy arrays.  ``x_init`` is an optional warm-start trajectory
    covering the item's real grid (``(N+1, nx)``).  ``prior`` is an
    optional information-form ``(S0, v0)`` left-boundary override.
    ``seq``/``base`` identify WHICH revision of a mutable source (a
    streaming track) was snapshotted: ``seq`` is the source's mutation
    counter and ``base`` its evicted-interval offset at snapshot time.
    """

    key: int
    ts: np.ndarray
    y: np.ndarray
    n_pad: int
    submit_t: float = 0.0          # perf_counter at submit; latency readout
    x_init: Optional[np.ndarray] = None
    prior: Optional[Tuple[np.ndarray, np.ndarray]] = None
    seq: int = 0                   # source mutation counter at snapshot
    base: int = 0                  # source evicted-interval offset at snapshot


@dataclasses.dataclass
class MergeResult:
    """Outcome of :func:`merge_measurements`.

    ``ts``/``y`` are the merged series (fresh arrays whenever anything
    changed -- the inputs are never mutated in place, so snapshots taken
    before the merge stay valid).  ``positions`` are the insertion points
    of the kept NEW measurements w.r.t. the ORIGINAL grid (``np.insert``
    semantics).  The counters partition the offered batch: ``appended``,
    ``merged`` (in-window insertions), ``replaced``/``dropped_duplicates``
    (duplicate policy), ``dropped_late`` (at or before the horizon).
    """

    ts: np.ndarray
    y: np.ndarray
    positions: np.ndarray
    appended: int = 0
    merged: int = 0
    replaced: int = 0
    dropped_late: int = 0
    dropped_duplicates: int = 0

    @property
    def changed(self) -> bool:
        """True when the series carries new information (re-solve needed)."""
        return bool(self.appended or self.merged or self.replaced)


DUPLICATE_POLICIES = ("error", "replace", "drop")


def merge_measurements(ts: np.ndarray, y: Optional[np.ndarray],
                       ts_new: np.ndarray, y_new: np.ndarray,
                       *, duplicate: str = "error") -> MergeResult:
    """Merge a sorted batch of measurements into a window series in time
    order.

    ``ts`` is the window grid (``(n+1,)``; ``ts[0]`` is the boundary
    point, measurements sit at ``ts[1:]``) and ``y`` its ``(n, ny)``
    measurements (``None`` for a fresh track).  ``ts_new`` must be
    strictly increasing WITHIN the batch but may land anywhere:

    * ``t > ts[-1]`` -- appended;
    * ``ts[0] < t < ts[-1]``, not on a grid point -- inserted in time order;
    * ``t`` exactly on an existing measurement point -- the ``duplicate``
      policy decides: ``"error"`` raises, ``"replace"`` overwrites that
      row, ``"drop"`` ignores it;
    * ``t <= ts[0]`` -- dropped and counted (``ts[0]`` is the committed
      horizon).
    """
    if duplicate not in DUPLICATE_POLICIES:
        raise ValueError(
            f"duplicate policy must be one of {DUPLICATE_POLICIES}, "
            f"got {duplicate!r}")
    ts = np.asarray(ts)
    ts_new = np.asarray(ts_new, dtype=float)
    y_new = np.asarray(y_new)
    n = ts.shape[0]

    late = ts_new <= ts[0]
    idx = np.searchsorted(ts, ts_new)
    dup = (idx < n) & (ts[np.minimum(idx, n - 1)] == ts_new) & ~late
    if dup.any() and duplicate == "error":
        raise ValueError(
            f"measurements at {ts_new[dup].tolist()} duplicate existing "
            "grid points (duplicate_policy='error'; use 'replace' or "
            "'drop' to accept re-sends)")
    replaced = 0
    if dup.any() and duplicate == "replace":
        y = y.copy()                       # never mutate a snapshotted array
        y[idx[dup] - 1] = y_new[dup]       # measurement for ts[i] is y[i-1]
        replaced = int(dup.sum())

    keep = ~late & ~dup
    positions = idx[keep]
    if keep.any():
        merged = int((ts_new[keep] < ts[-1]).sum())
        ts = np.insert(ts, positions, ts_new[keep])
        rows = y_new[keep]
        y = rows.copy() if y is None else np.insert(y, positions - 1, rows,
                                                    axis=0)
    else:
        merged = 0
    return MergeResult(
        ts=ts, y=y, positions=positions,
        appended=int(keep.sum()) - merged, merged=merged, replaced=replaced,
        dropped_late=int(late.sum()),
        dropped_duplicates=int(dup.sum()) if duplicate == "drop" else 0)


def insert_warm_states(x_warm: np.ndarray,
                       positions: np.ndarray) -> np.ndarray:
    """Keep a warm-start trajectory aligned after in-window insertions:
    each inserted grid point takes its LEFT neighbour's state (a
    zero-order hold; the warm start is only a linearisation hint).
    ``positions`` are original-grid insertion points (``np.insert``
    semantics); points past the trajectory's end are ignored --
    :func:`_pad_trajectory` repeats the final state over any un-warmed
    tail."""
    pos = np.asarray(positions, dtype=int)
    pos = pos[pos <= x_warm.shape[0] - 1]
    if pos.size == 0:
        return x_warm
    return np.insert(x_warm, pos, x_warm[np.maximum(pos - 1, 0)], axis=0)


def validate_record(ts, y) -> Tuple[np.ndarray, np.ndarray]:
    """Shared submit-time validation: shapes and a strictly-increasing
    time grid.  Returns ``(ts, y)`` as numpy arrays (tensors are copied
    to the host)."""
    ts = np.asarray(ts.cpu() if isinstance(ts, torch.Tensor) else ts)
    y = np.asarray(y.cpu() if isinstance(y, torch.Tensor) else y)
    if y.ndim != 2 or y.shape[0] < 1:
        raise ValueError(
            f"y must be (N, ny) with N >= 1, got shape {y.shape}")
    if ts.shape != (y.shape[0] + 1,):
        raise ValueError(
            f"ts must be (N+1,) = {(y.shape[0] + 1,)}, got {ts.shape}")
    if not np.all(np.diff(ts) > 0):
        raise ValueError(
            "ts must be strictly increasing (padding extrapolates the "
            f"grid with the final step, which a non-monotone or repeated "
            f"time point would corrupt); got ts={ts!r}")
    return ts, y


def _wave_key(item: WaveItem) -> Tuple[int, bool, bool]:
    """What a wave's items must share: the bucket, and whether they carry
    a warm start and a boundary prior (:func:`pack_wave` stacks either
    for every row or for none)."""
    return item.n_pad, item.x_init is None, item.prior is None


def take_wave(queue: Deque[WaveItem], batch: int) -> List[WaveItem]:
    """FIFO wave: the oldest item fixes the bucket (and whether the rows
    carry warm starts and priors); later items of the same kind top the
    wave up to ``batch`` (others keep their place).  Scanning stops as
    soon as the wave is full.  Mutates ``queue``."""
    key = _wave_key(queue[0])
    wave: List[WaveItem] = []
    keep: Deque[WaveItem] = collections.deque()
    while queue and len(wave) < batch:
        item = queue.popleft()
        if _wave_key(item) == key:
            wave.append(item)
        else:
            keep.append(item)
    keep.extend(queue)                 # untouched tail, order preserved
    queue.clear()
    queue.extend(keep)
    return wave


def _pad_trajectory(x: np.ndarray, n_pad: int) -> np.ndarray:
    """Extend a warm-start trajectory ``(N+1, nx)`` to ``(n_pad+1, nx)``
    by repeating the final state."""
    extra = n_pad + 1 - x.shape[0]
    if extra <= 0:
        return x[:n_pad + 1]
    return np.concatenate([x, np.repeat(x[-1:], extra, axis=0)], axis=0)


def pack_wave(wave: List[WaveItem], batch: int, *, device=None,
              dtype=torch.float64):
    """Pad + stack a same-bucket wave into stacked-problem tensors on
    ``device``.

    Returns ``(ts_b, ys_b, mask_b, x_init_b, prior_b)`` with exactly
    ``batch`` rows -- short waves recycle row 0.  Every record is padded
    on the host and the rows are stacked there, so each returned tensor
    is one host-to-device copy.  ``x_init_b`` is ``(batch, n_pad+1, nx)``
    when the items carry warm starts; ``prior_b`` stacks per-row
    ``(S0, v0)`` likewise (a wave must not mix items with and without
    them).
    """
    n_pad = wave[0].n_pad

    def put(rows):
        return torch.as_tensor(np.stack(rows)).to(device=device, dtype=dtype)

    padded = [pad_record(torch.tensor(it.ts), torch.tensor(it.y), n_pad)
              for it in wave]
    rows = padded + [padded[0]] * (batch - len(padded))
    ts_b, ys_b, mask_b = (
        torch.stack([r[j] for r in rows]).to(device=device, dtype=dtype)
        for j in range(3))

    x_init_b = None
    if any(it.x_init is not None for it in wave):
        if not all(it.x_init is not None for it in wave):
            raise ValueError(
                "wave mixes items with and without warm-start trajectories")
        xi_rows = [_pad_trajectory(np.asarray(it.x_init), n_pad)
                   for it in wave]
        x_init_b = put(xi_rows + [xi_rows[0]] * (batch - len(xi_rows)))

    prior_b = None
    if any(it.prior is not None for it in wave):
        if not all(it.prior is not None for it in wave):
            raise ValueError(
                "wave mixes items with and without boundary priors")
        recycle = [wave[0]] * (batch - len(wave))
        prior_b = tuple(put([np.asarray(it.prior[j]) for it in wave + recycle])
                        for j in range(2))
    return ts_b, ys_b, mask_b, x_init_b, prior_b


def record_wave_metrics(prefix: str, wave: List[WaveItem], n_pad: int,
                        batch: int, queue_depth: int) -> None:
    """Per-wave obs readout under ``prefix`` (``engine`` / ``stream``):
    waves/completed/recycled counters, interval-padding accounting, the
    cumulative ``<prefix>.padding_waste`` gauge, wave occupancy, queue
    depth and the per-item submit-to-done latency histogram."""
    now = time.perf_counter()
    real = sum(it.y.shape[0] for it in wave)
    solved = n_pad * batch
    obs.inc(f"{prefix}.waves")
    obs.inc(f"{prefix}.completed", len(wave))
    obs.inc(f"{prefix}.recycled_rows", batch - len(wave))
    obs.inc(f"{prefix}.real_intervals", real)
    obs.inc(f"{prefix}.padded_intervals", solved)
    obs.record(f"{prefix}.wave_occupancy", len(wave) / batch,
               buckets=[i / 20 for i in range(21)])
    # cumulative padding waste: fraction of solved intervals that were
    # padding or recycled rows (0 = perfect packing)
    c = obs.REGISTRY.counter
    total_real = c(f"{prefix}.real_intervals").value
    total_solved = c(f"{prefix}.padded_intervals").value
    if total_solved:
        obs.set_gauge(f"{prefix}.padding_waste",
                      1.0 - total_real / total_solved)
    obs.set_gauge(f"{prefix}.queue_depth", queue_depth)
    latency = ("engine.record_latency_seconds" if prefix == "engine"
               else f"{prefix}.window_latency_seconds")
    for it in wave:
        obs.record(latency, now - it.submit_t)
