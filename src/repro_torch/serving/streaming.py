"""Streaming fixed-lag estimation service.

``StreamingEngine`` turns the batch :class:`~repro_torch.core.Estimator`
into an online service (the counterpart of the reference's
``repro/serving/streaming.py``): clients open tracks, push measurements as they arrive, and
read back MAP estimates that are continuously refined over a sliding
window of the most recent ``lag`` intervals.

Fixed-lag smoothing, exactly
----------------------------

Every window re-solve passes the *filter information at the window's left
edge* -- ``(Solution.S[k], Solution.v[k])`` of the previous solve -- as an
information-form boundary prior (``Problem(..., prior=(S0, v0))``).  For
linear models this makes the chained window solves EXACTLY equal to the
one-shot offline MAP restricted to the window (the information recursion
is the same sums in a different order).  States older than the lag are **evicted**: committed as final
:class:`~repro_torch.core.Solution` segments and never re-solved.  A committed
state is the MAP estimate given all measurements up to ``lag`` intervals
after it -- the classic fixed-lag approximation, exact in the window and
within smoothing-decay of the full MAP behind it (docs/STREAMING.md, the
reference's documentation, holds for the port).

Nonlinear models additionally warm-start each re-solve from the previous
window's trajectory (per-row ``x_init``), so the iterated smoother
re-linearises from an already-converged nominal instead of the prior
mean.

Late and out-of-order data
--------------------------

Real feeds deliver measurements late.  ``push`` accepts timestamps
anywhere relative to the track's grid: in-order points append, points
that land *inside the live window* are merged in time order and the
window is re-solved from the unchanged boundary prior (so in-window late
data costs nothing in exactness -- the prior only summarises evicted
history), duplicates of existing points follow the engine's
``duplicate_policy`` (``"error"`` / ``"replace"`` / ``"drop"``), and
points at or before the committed horizon are counted and dropped
(``stream.late_drops``).  ``reorder_slack`` keeps that horizon
``reorder_slack`` intervals further back than the lag -- a per-track
reorder buffer implemented by delaying eviction, so near-late data still
merges instead of dropping.  Merges racing an in-flight solve are safe:
when the mutation touches the region that solve is about to evict, the
eviction is deferred to the re-solve the merge itself queued
(``stream.deferred_evictions``), never sliced off a grid the snapshot no
longer describes.

Adaptive lag
------------

With ``committed_error_target`` set the engine self-tunes ``lag`` inside
``[lag_min, lag_max]``: every eviction observes how much the
about-to-be-committed states still moved since their previous solve (the
smoothing-decay signal) and grows the lag while that residual update
exceeds the target, shrinks it when the residual is comfortably below --
converging to the smallest lag that meets the target instead of a
hand-tuned constant (docs/STREAMING.md has the control law).

Batching
--------

Due windows (tracks with un-solved pushes) are drained in fixed-size
waves through the same machinery as :class:`TrajectoryEngine`
(:mod:`repro_torch.serving.waves`): FIFO by first-push time, grouped by
padded bucket length, short waves recycle a live row.  Windows across
DIFFERENT tracks batch together -- that is the point of a fixed window
size: every track's window pads to the same few bucket lengths, and each
wave is one stacked solve (one scan-kernel launch per backward scan with
``method="parallel_kernel"``).

Host and device
---------------

Per-track state (grids, measurements, boundary priors, warm starts,
committed segments) is numpy float64 on the host; merges and evictions
never touch the card.  A wave is padded and stacked on the host and
copied to the estimator's device once per stacked array; its solution
comes back to the host in one copy per wave, and is sliced per row there.

Observability: with :mod:`repro_torch.obs` enabled the engine reports the
``stream.*`` taxonomy (pushes, open tracks, per-wave occupancy/padding,
``stream.window_latency_seconds`` push-to-solve latency, eviction, late
and adaptive-lag counters) -- see docs/OBSERVABILITY.md.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.estimator import Estimator, Problem
from repro_torch.core.padding import bucket_length
from repro_torch.core.sde import LinearSDE, NonlinearSDE
from repro_torch.core.types import Solution

from .trajectory import check_wave_batch

from .waves import (
    DUPLICATE_POLICIES,
    WaveItem,
    insert_warm_states,
    merge_measurements,
    pack_wave,
    record_wave_metrics,
    robust_default_options,
    take_wave,
)

# Adaptive-lag hysteresis: shrink only when the eviction residual is
# below this fraction of the target, so the lag settles instead of
# oscillating between grow and shrink around the threshold.  0.6 keeps
# the stable band within ~2 intervals of the smallest sufficient lag for
# smoothing-decay rates down to ~1.3x per interval while still leaving a
# 1.67x dead zone against residual jitter.
_LAG_SHRINK_RATIO = 0.6


def _zoh_resample(x: np.ndarray, snap_ts: np.ndarray,
                  cur_ts: np.ndarray) -> np.ndarray:
    """Zero-order-hold resample of a solved trajectory onto a mutated
    grid: grid points present at solve time keep their state, points
    merged since take their LEFT neighbour's, points appended since the
    final state (the same hold as :func:`insert_warm_states` /
    ``_pad_trajectory`` -- the result is only a warm-start hint)."""
    idx = np.searchsorted(snap_ts, cur_ts, side="right") - 1
    return x[np.maximum(idx, 0)]


def _to_host(sol: Solution):
    """A wave's ``(x, S, v, cost)`` as numpy arrays, in ONE
    device-to-host copy: the fields are flattened per row and
    concatenated on the device first."""
    B = sol.x.shape[0]
    parts = [sol.x, sol.S, sol.v] + ([] if sol.cost is None
                                     else [sol.cost])
    flat = torch.cat([p.reshape(B, -1) for p in parts], dim=1).cpu().numpy()
    out, at = [], 0
    for p in parts:
        size = p[0].numel()
        out.append(flat[:, at:at + size].reshape(tuple(p.shape)))
        at += size
    x, S, v = out[:3]
    return x, S, v, (out[3] if sol.cost is not None else None)


def _solution(x: np.ndarray, S: np.ndarray, v: np.ndarray,
              cost: Optional[float] = None) -> Solution:
    """A reader's :class:`Solution`: CPU tensors copied from host arrays
    (callers cannot mutate the engine's state through them)."""
    return Solution(
        x=torch.tensor(x), S=torch.tensor(S), v=torch.tensor(v),
        cost=None if cost is None else torch.tensor(cost,
                                                     dtype=torch.float64))


class _Track:
    """Per-track streaming state (mutated only under the engine lock).

    ``offset`` counts evicted intervals: the live window covers track
    intervals ``[offset, offset + y.shape[0])``.  ``committed_*`` hold the
    retained evicted history; ``win_*`` the window estimate of the last
    solve (``win_ts`` its time grid, so later merges can be told apart
    from it); ``prior`` the information-form boundary at the window's
    left edge (``None`` until the first eviction -- the model prior
    applies).  ``seq`` counts data mutations (pushes/merges/replaces) and
    ``applied_seq`` the last snapshot folded back in, so out-of-order
    solve results are never applied twice or backwards.
    """

    __slots__ = ("ts", "y", "offset", "prior", "x_warm", "win_x", "win_S",
                 "win_v", "win_ts", "committed_x", "committed_S",
                 "committed_v", "due_since", "solves", "last_cost", "seq",
                 "applied_seq", "trimmed", "last_evict_delta")

    def __init__(self, t0: float):
        self.ts = np.asarray([t0], dtype=float)
        self.y: Optional[np.ndarray] = None        # (N, ny) window intervals
        self.offset = 0                            # evicted intervals
        self.prior: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.x_warm: Optional[np.ndarray] = None   # (N+1, nx) last window x
        self.win_x: Optional[np.ndarray] = None    # last SOLVED window
        self.win_S: Optional[np.ndarray] = None
        self.win_v: Optional[np.ndarray] = None
        self.win_ts: Optional[np.ndarray] = None   # time grid of win_x rows
        self.committed_x: List[np.ndarray] = []
        self.committed_S: List[np.ndarray] = []
        self.committed_v: List[np.ndarray] = []
        # perf_counter the track last became due.  Initialised to NOW (not
        # 0.0): a track marked due by any path that forgets to stamp it
        # must never leak an epoch-relative duration into the
        # stream.window_latency_seconds histogram.
        self.due_since = time.perf_counter()
        self.solves = 0
        self.last_cost: Optional[float] = None
        self.seq = 0                # data mutations (push/merge/replace)
        self.applied_seq = -1       # seq of the last applied solve snapshot
        self.trimmed = 0            # committed states dropped by the cap
        self.last_evict_delta: Optional[float] = None

    @property
    def intervals(self) -> int:
        """Total intervals pushed so far (committed + window)."""
        return self.offset + (0 if self.y is None else self.y.shape[0])


class StreamingEngine:
    """Multi-track fixed-lag smoother service over one model.

    Args:
      model: shared :class:`LinearSDE` / :class:`NonlinearSDE`.
      lag: window length in INTERVALS kept live behind the newest
        measurement; anything older is evicted as committed history after
        the next solve.  Larger lag = closer to the full MAP for the
        committed states, more work per re-solve.  With
        ``committed_error_target`` set this is only the INITIAL lag.
      batch: fixed wave size -- due windows from different tracks are
        solved ``batch`` at a time, one stacked solve per wave.
      duplicate_policy: what a push whose timestamp exactly matches an
        existing window grid point does -- ``"error"`` (default: raise),
        ``"replace"`` (overwrite that measurement and re-solve) or
        ``"drop"`` (ignore it, counted in ``stream.duplicates_dropped``).
      reorder_slack: extra intervals (beyond the lag) the window keeps
        live before committing them -- a per-track reorder buffer that
        delays eviction so measurements up to ``lag + reorder_slack``
        intervals behind the newest still merge instead of being dropped
        at the committed horizon.
      max_committed_states: optional cap on the retained committed
        history per track (long-lived tracks otherwise grow without
        bound).  The OLDEST committed states are trimmed past the cap
        (``stream.committed_trimmed``); ``committed()`` / ``estimate()``
        / ``close()`` then return only the retained suffix.
      committed_error_target: enables adaptive lag.  After each eviction
        the engine measures how much the evicted states still changed in
        their final solve (max-abs update vs the previous window solve)
        and steers ``lag`` within ``[lag_min, lag_max]`` so that residual
        meets the target: grow while above, shrink while below
        ``_LAG_SHRINK_RATIO x`` the target.
      lag_min / lag_max: adaptive-lag bounds (default ``1`` and
        ``4 * lag``); only meaningful with ``committed_error_target``.
      method / options / device: forwarded to the underlying
        :class:`~repro_torch.core.Estimator` (same surface as
        :class:`TrajectoryEngine`; ``options=None`` = method defaults in
        the robust ``discrete`` element mode, see
        :func:`repro_torch.serving.waves.robust_default_options`;
        ``device=None`` means ``"cuda"``, and raises without a card).
      mesh / batch_axis: forwarded to the Estimator (as
        :class:`TrajectoryEngine`'s); ``batch`` must be a multiple of the
        mesh's batch axis.
      diagnostics: forwarded to the Estimator; the streaming default is
        ``False`` (skip cost/step-norm traces -- latency path).

    API: ``open_track(t0) -> id``; ``push(id, ts_new, y_new)`` merges
    measurements in time order (see the module docstring for late-data
    semantics) and returns the per-category counts; ``step()`` solves one
    wave of due windows; ``run()`` drains; ``estimate(id)`` solves any
    outstanding pushes for that track and returns the stitched committed
    + window :class:`Solution` (``refresh=False`` skips the solve and
    returns the last-solved state); ``window(id)`` / ``committed(id)``
    the parts; ``close(id)`` finalises and removes the track.  The
    readers return :class:`~repro_torch.core.Solution`\\ s of CPU tensors
    built from the host state.

    ``open_track``/``push``/``estimate``/``collect``-style readers are
    thread-safe; drive ``step``/``run`` from ONE solver thread while
    clients push concurrently (pushes landing mid-solve simply mark the
    track due again, per-track snapshot sequence numbers keep
    ``estimate``-triggered solves and the solver thread from ever
    applying a stale window result, and a mid-solve merge into the
    about-to-be-evicted region defers that eviction to the re-solve the
    merge queued -- ``stream.deferred_evictions`` -- instead of slicing
    the mutated grid by stale indices).  ``estimate(refresh=True)``
    waits out an in-flight solve of its track, so the result reflects
    every push accepted before the call.
    """

    def __init__(
        self,
        model: Union[LinearSDE, NonlinearSDE],
        *,
        lag: int = 32,
        batch: int = 8,
        method: str = "parallel_rts",
        options=None,
        bucket_sizes: Optional[Sequence[int]] = None,
        device=None,
        mesh=None,
        batch_axis: str = "data",
        diagnostics: bool = False,
        duplicate_policy: str = "error",
        reorder_slack: int = 0,
        max_committed_states: Optional[int] = None,
        committed_error_target: Optional[float] = None,
        lag_min: Optional[int] = None,
        lag_max: Optional[int] = None,
    ):
        if lag < 1:
            raise ValueError(f"lag must be >= 1 interval, got {lag}")
        if options is None:
            # serving default: the robust exact-composition mode -- a
            # streaming window grows without bound between solves, so the
            # length-dependent stability of the euler default is exactly
            # the failure mode to avoid (see robust_default_options).
            options = robust_default_options(method)
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        if duplicate_policy not in DUPLICATE_POLICIES:
            raise ValueError(
                f"duplicate_policy must be one of {DUPLICATE_POLICIES}, "
                f"got {duplicate_policy!r}")
        if reorder_slack < 0:
            raise ValueError(
                f"reorder_slack must be >= 0 intervals, got {reorder_slack}")
        if max_committed_states is not None and max_committed_states < 0:
            raise ValueError(
                f"max_committed_states must be >= 0 or None, got "
                f"{max_committed_states}")
        if committed_error_target is None:
            if lag_min is not None or lag_max is not None:
                raise ValueError(
                    "lag_min/lag_max only apply to adaptive lag -- set "
                    "committed_error_target to enable it")
        else:
            if committed_error_target <= 0:
                raise ValueError(
                    f"committed_error_target must be > 0, got "
                    f"{committed_error_target}")
            lag_min = 1 if lag_min is None else lag_min
            lag_max = 4 * lag if lag_max is None else lag_max
            if lag_min < 1:
                raise ValueError(f"lag_min must be >= 1, got {lag_min}")
            if lag_max < lag_min:
                raise ValueError(
                    f"lag_max ({lag_max}) must be >= lag_min ({lag_min})")
            lag = min(max(lag, lag_min), lag_max)
        self.estimator = Estimator(model, method=method, options=options,
                                   device=device, mesh=mesh,
                                   batch_axis=batch_axis,
                                   diagnostics=diagnostics)
        check_wave_batch(self.estimator, batch)
        self.model = model
        self._m0 = model.m0.detach().cpu().numpy()
        self.lag = lag
        self.batch = batch
        self.bucket_sizes = bucket_sizes
        self.nonlinear = isinstance(model, NonlinearSDE)
        self.duplicate_policy = duplicate_policy
        self.reorder_slack = reorder_slack
        self.max_committed_states = max_committed_states
        self.committed_error_target = committed_error_target
        self.lag_min = lag_min
        self.lag_max = lag_max
        self.lag_adjustments = 0

        self._lock = threading.Lock()
        # signalled whenever an in-flight wave lands (or fails): lets
        # estimate(refresh=True) wait out a solve that snapshotted the
        # track before the call
        self._cond = threading.Condition(self._lock)
        self._inflight: Dict[int, int] = {}   # track id -> solves in flight
        self._tracks: Dict[int, _Track] = {}
        # track id -> insertion order IS the FIFO due order
        self._due: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        self._next_id = 0
        self.waves = 0
        self.evicted_intervals = 0

    # -- client surface -----------------------------------------------------

    def open_track(self, t0: float = 0.0) -> int:
        """Open a streaming track whose time grid starts at ``t0``;
        returns the track id used by every other call."""
        with self._lock:
            tid = self._next_id
            self._next_id += 1
            self._tracks[tid] = _Track(float(t0))
            n = len(self._tracks)
        if obs.enabled():
            obs.inc("stream.tracks_opened")
            obs.set_gauge("stream.tracks", n)
        return tid

    def push(self, track_id: int, ts_new, y_new) -> Dict[str, int]:
        """Merge measurements into a track in time order and mark it due.

        ``ts_new`` (``(K,)``, strictly increasing within the batch) are
        grid points anywhere relative to the track: after the last time
        (append), inside the live window (late merge -- the window is
        re-solved with them in place), exactly on an existing point
        (``duplicate_policy`` applies), or at/before the committed
        horizon (dropped + counted).  ``y_new`` is ``(K, ny)``.

        Returns the per-category counts: ``{"appended", "merged",
        "replaced", "dropped_late", "dropped_duplicates"}``.
        """
        ts_new = np.asarray(ts_new, dtype=float)
        y_new = np.asarray(y_new)
        if ts_new.ndim != 1 or ts_new.shape[0] < 1:
            raise ValueError(
                f"ts_new must be (K,) with K >= 1, got shape {ts_new.shape}")
        if y_new.ndim != 2 or y_new.shape[0] != ts_new.shape[0]:
            raise ValueError(
                f"y_new must be (K, ny) = ({ts_new.shape[0]}, ny), got "
                f"shape {y_new.shape}")
        if not np.all(np.diff(ts_new) > 0):
            raise ValueError(
                f"ts_new must be strictly increasing; got {ts_new!r}")
        ny = self.model.ny
        if ny is not None and y_new.shape[1] != ny:
            raise ValueError(
                f"y_new has measurement dimension {y_new.shape[1]} but "
                f"the model's R is {ny}x{ny} (ny={ny})")
        with self._lock:
            track = self._get(track_id)
            if track.y is not None and y_new.shape[1] != track.y.shape[1]:
                raise ValueError(
                    f"y_new has ny={y_new.shape[1]}, track has "
                    f"ny={track.y.shape[1]}")
            res = merge_measurements(track.ts, track.y, ts_new, y_new,
                                     duplicate=self.duplicate_policy)
            track.ts, track.y = res.ts, res.y
            if res.changed:
                track.seq += 1
                if res.merged and track.x_warm is not None:
                    track.x_warm = insert_warm_states(track.x_warm,
                                                      res.positions)
                self._mark_due(track_id, track)
            depth = len(self._due)
        if obs.enabled():
            obs.inc("stream.pushes")
            # accepted intervals only -- drops (late / duplicate-drop)
            # are counted by their own stream.* counters below
            obs.inc("stream.pushed_intervals",
                    res.appended + res.merged + res.replaced)
            obs.set_gauge("stream.queue_depth", depth)
            if res.merged:
                obs.inc("stream.late_merges", res.merged)
            if res.dropped_late:
                obs.inc("stream.late_drops", res.dropped_late)
            if res.replaced:
                obs.inc("stream.duplicates_replaced", res.replaced)
            if res.dropped_duplicates:
                obs.inc("stream.duplicates_dropped", res.dropped_duplicates)
        return {"appended": res.appended, "merged": res.merged,
                "replaced": res.replaced, "dropped_late": res.dropped_late,
                "dropped_duplicates": res.dropped_duplicates}

    def due(self) -> int:
        """Number of tracks with un-solved pushes."""
        return len(self._due)

    def tracks(self) -> List[int]:
        with self._lock:
            return sorted(self._tracks)

    # -- wave processing ----------------------------------------------------

    def step(self) -> int:
        """Solve one wave of due windows; returns windows solved (0 if
        nothing is due).  Snapshots each due track's CURRENT window, so a
        push landing mid-solve marks the track due again for the next
        wave rather than being lost."""
        with self._lock:
            if not self._due:
                return 0
            queue = collections.deque(
                self._snapshot(tid) for tid in self._due)
            wave = take_wave(queue, self.batch)
            for item in wave:
                del self._due[item.key]
                self._inflight[item.key] = \
                    self._inflight.get(item.key, 0) + 1
            depth = len(self._due)
        self._solve_wave(wave, depth)
        return len(wave)

    def _solve_wave(self, wave: List[WaveItem], depth: int) -> None:
        """Solve one snapshotted wave outside the lock and fold the
        results back in.  Always clears the wave's in-flight marks and
        wakes waiting ``estimate(refresh=True)`` callers, even when the
        solve raises."""
        try:
            with obs.trace_span("stream.step"):
                n_pad = wave[0].n_pad
                ts_b, ys_b, mask_b, xi_b, pr_b = pack_wave(
                    wave, self.batch, device=self.estimator.device,
                    dtype=self.estimator._model.dtype)
                sol = self.estimator.solve(
                    Problem.stacked(self.model, ts_b, ys_b,
                                    measurement_mask=mask_b,
                                    x_init=xi_b, prior=pr_b))
                x, S, v, cost = _to_host(sol)
                with self._lock:
                    for row, item in enumerate(wave):
                        # per-row copies: a track keeps its own arrays,
                        # not views that pin the whole wave's buffer
                        k = item.y.shape[0] + 1
                        self._apply(item, x[row, :k].copy(),
                                    S[row, :k].copy(), v[row, :k].copy(),
                                    None if cost is None else cost[row])
                    self.waves += 1
                if obs.enabled():
                    record_wave_metrics("stream", wave, n_pad, self.batch,
                                        depth)
                    obs.set_gauge("stream.lag", self.lag)
        finally:
            with self._lock:
                for item in wave:
                    left = self._inflight.pop(item.key, 1) - 1
                    if left > 0:
                        self._inflight[item.key] = left
                self._cond.notify_all()

    def run(self) -> int:
        """Drain every due window; returns total windows solved.  With
        :mod:`repro_torch.obs` enabled sets ``stream.windows_per_sec``."""
        total = 0
        t0 = time.perf_counter()
        with obs.trace_span("stream.run"):
            while self._due:
                total += self.step()
        dt = time.perf_counter() - t0
        if total and dt > 0:
            obs.set_gauge("stream.windows_per_sec", total / dt)
        return total

    # -- estimates ----------------------------------------------------------

    def estimate(self, track_id: int, *, refresh: bool = True) -> Solution:
        """Stitched committed + window estimate: ``x``/``S``/``v`` over
        the track's solved time points (all of them, unless
        ``max_committed_states`` trimmed old history -- then the retained
        suffix).

        By default the estimate is FRESH: every push accepted before
        this call is reflected in the result.  A track with un-solved
        pushes is solved on demand first (a single-track wave), and if a
        ``step()``/``run()`` solve of this track is already in flight
        the call WAITS for it to land before re-checking -- a push that
        arrived mid-solve triggers the on-demand solve; whichever solve
        lands first wins and the other is discarded by the snapshot
        sequence check.  ``refresh=False`` returns the last-solved state
        as-is, which silently EXCLUDES any newer or in-flight pushes --
        the fast read for dashboards that poll while a solver thread
        drains.

        ``S``/``v`` are the forward-filter information at each point (the
        quantity the window handoff chains on).  The fields are CPU
        tensors.
        """
        if refresh:
            self._refresh(track_id)
        with self._lock:
            track = self._get(track_id)
            if track.win_x is None:
                raise ValueError(
                    f"track {track_id} has no estimate yet -- push "
                    "measurements and call step()/run() first")
            return _solution(
                np.concatenate(track.committed_x + [track.win_x]),
                np.concatenate(track.committed_S + [track.win_S]),
                np.concatenate(track.committed_v + [track.win_v]),
                track.last_cost)

    def _refresh(self, track_id: int) -> None:
        """Make ``track_id``'s estimate fresh: solve its window now if
        it has un-solved pushes (one single-track wave, off the FIFO),
        first waiting out any ``step()``/``run()`` solve of this track
        already in flight -- a mid-solve track is no longer in the due
        set, but its result has not landed either, so returning without
        waiting would silently exclude those pushes."""
        with self._lock:
            while True:
                self._get(track_id)
                if track_id in self._due:
                    item = self._snapshot(track_id)
                    del self._due[track_id]
                    self._inflight[track_id] = \
                        self._inflight.get(track_id, 0) + 1
                    depth = len(self._due)
                    break
                if not self._inflight.get(track_id):
                    return                 # nothing un-solved or in flight
                # snapshotted by a solver thread: wait for that wave to
                # land, then re-check (a push may have arrived mid-solve
                # and marked the track due again)
                self._cond.wait()
        if obs.enabled():
            obs.inc("stream.refresh_solves")
        self._solve_wave([item], depth)

    def window(self, track_id: int) -> Solution:
        """The live window's estimate alone (last solve; ``lag + 1`` states
        once the track is past its lag)."""
        with self._lock:
            track = self._get(track_id)
            if track.win_x is None:
                raise ValueError(
                    f"track {track_id} has no estimate yet -- push "
                    "measurements and call step()/run() first")
            return _solution(track.win_x, track.win_S, track.win_v)

    def committed(self, track_id: int) -> Optional[Solution]:
        """The evicted (finalised) history as a Solution segment, or
        ``None`` if nothing has been evicted yet.  Committed states are
        never re-solved; with ``max_committed_states`` set this is the
        RETAINED suffix (the oldest states past the cap are gone --
        ``stream.committed_trimmed`` counts them)."""
        with self._lock:
            track = self._get(track_id)
            if not track.committed_x:
                return None
            return _solution(np.concatenate(track.committed_x),
                             np.concatenate(track.committed_S),
                             np.concatenate(track.committed_v))

    def close(self, track_id: int) -> Solution:
        """Finalise a track: solve any outstanding pushes, return the full
        stitched estimate (the retained suffix under
        ``max_committed_states``), and drop the track's state."""
        final = self.estimate(track_id)
        with self._lock:
            del self._tracks[track_id]
            self._due.pop(track_id, None)
            n = len(self._tracks)
        if obs.enabled():
            obs.inc("stream.tracks_closed")
            obs.set_gauge("stream.tracks", n)
        return final

    # -- internals ----------------------------------------------------------

    def _get(self, track_id: int) -> _Track:
        try:
            return self._tracks[track_id]
        except KeyError:
            raise KeyError(
                f"unknown track id {track_id} (open tracks: "
                f"{sorted(self._tracks)})") from None

    def _mark_due(self, track_id: int, track: _Track) -> None:
        """Add a track to the due set (caller holds lock), stamping
        ``due_since`` only on the transition so the latency histogram
        measures first-unsolved-change to solved."""
        if track_id not in self._due:
            track.due_since = time.perf_counter()
            self._due[track_id] = None

    def _snapshot(self, tid: int) -> WaveItem:
        """WaveItem for a due track's current window (caller holds lock).
        Arrays are never mutated in place (pushes re-concatenate), so the
        references stay valid while the solve runs outside the lock."""
        track = self._tracks[tid]
        n_pad = bucket_length(track.y.shape[0], self.estimator.block_size,
                              self.bucket_sizes)
        x_init = None
        if self.nonlinear:
            # uniform warm start across the wave: re-solves continue from
            # the previous window trajectory, fresh windows from the prior
            # mean (= iterated_solve's own default)
            if track.x_warm is not None:
                x_init = track.x_warm
            elif track.prior is None:
                x_init = np.broadcast_to(
                    self._m0, (track.y.shape[0] + 1,) + self._m0.shape)
            else:
                mean = np.linalg.solve(track.prior[0], track.prior[1])
                x_init = np.broadcast_to(
                    mean, (track.y.shape[0] + 1,) + mean.shape)
        return WaveItem(tid, track.ts, track.y, n_pad, track.due_since,
                        x_init=x_init, prior=track.prior,
                        seq=track.seq, base=track.offset)

    def _apply(self, item: WaveItem, x: np.ndarray, S: np.ndarray,
               v: np.ndarray, cost: Optional[float]) -> None:
        """Fold one window solution (host arrays over the snapshot's
        ``N+1`` points) back into its track (caller holds lock): store the
        window estimate, evict past the lag (+ reorder slack), advance the
        boundary prior and warm start, steer the adaptive lag.

        Solve results may land out of order when an ``estimate()``
        refresh races the solver thread: a result older than the last
        applied snapshot (``seq``) is discarded, and a newer result whose
        snapshot predates an eviction is re-based via ``item.base`` so it
        never double-commits states.

        A push landing WHILE this solve was in flight (``track.seq !=
        item.seq``) may also have mutated the grid itself.  Eviction
        slices ``track.ts``/``track.y`` by snapshot index, so it only
        proceeds if the to-be-evicted region of the CURRENT grid still
        matches the snapshot (mid-solve appends, and merges/replaces past
        the boundary, keep it intact); a merge or replace inside that
        region would make the slice drop the wrong points -- and the
        snapshot solve never saw that data anyway -- so eviction is
        deferred to the re-solve the mutating push already queued
        (``stream.deferred_evictions``)."""
        track = self._tracks.get(item.key)
        if track is None:                      # closed mid-solve
            return
        if item.seq <= track.applied_seq:      # a newer solve already landed
            return
        track.applied_seq = item.seq
        n = item.y.shape[0]                    # window intervals at snapshot
        # x[i] is the state at absolute interval item.base + i; `shift`
        # intervals of the snapshot were already committed by an apply
        # that raced ahead of this one.
        shift = track.offset - item.base
        keep = self.lag + self.reorder_slack
        evict = max(0, (item.base + max(0, n - keep)) - track.offset)
        if evict and track.seq != item.seq and \
                not self._evict_region_unchanged(track, item, shift, evict):
            evict = 0
            if obs.enabled():
                obs.inc("stream.deferred_evictions")
        if evict:
            self._observe_eviction(track, x[shift:shift + evict],
                                   item.ts[shift:shift + evict])
            track.committed_x.append(x[shift:shift + evict])
            track.committed_S.append(S[shift:shift + evict])
            track.committed_v.append(v[shift:shift + evict])
            track.prior = (S[shift + evict].copy(), v[shift + evict].copy())
            track.ts = track.ts[evict:]
            track.y = track.y[evict:]
            track.offset += evict
            self.evicted_intervals += evict
            self._trim_committed(track)
            if obs.enabled():
                obs.inc("stream.evicted_intervals", evict)
        track.win_x, track.win_S, track.win_v = \
            x[shift + evict:], S[shift + evict:], v[shift + evict:]
        track.win_ts = item.ts[shift + evict:]
        if self.nonlinear:
            x_warm = x[shift + evict:]
            if track.seq != item.seq:
                # mid-solve pushes mutated the grid: re-align the warm
                # start onto it (a misaligned hint would hand the next
                # iterated solve neighbouring states at every point past
                # the first insertion)
                x_warm = _zoh_resample(x_warm, item.ts[shift + evict:],
                                       track.ts)
            track.x_warm = x_warm
        else:
            track.x_warm = None
        track.solves += 1
        if cost is not None:
            track.last_cost = float(cost)

    def _evict_region_unchanged(self, track: _Track, item: WaveItem,
                                shift: int, evict: int) -> bool:
        """True when the current grid still matches ``item``'s snapshot
        over the to-be-evicted region -- the first ``evict + 1`` grid
        points (boundary included) and their measurements -- so slicing
        ``track.ts``/``track.y`` by snapshot index is safe even though
        the track mutated mid-solve (caller holds lock)."""
        m = evict + 1
        return (track.ts.shape[0] >= m
                and bool(np.array_equal(track.ts[:m],
                                        item.ts[shift:shift + m]))
                and bool(np.array_equal(track.y[:evict],
                                        item.y[shift:shift + evict])))

    def _observe_eviction(self, track: _Track, evicted_x: np.ndarray,
                          evicted_ts: np.ndarray) -> None:
        """Measure the smoothing residual of the states about to be
        committed -- how much their estimate still changed between the
        previous solve and this (final) one -- and steer the adaptive lag
        (caller holds lock).

        Rows are matched by TIMESTAMP against the previous window
        (``win_ts``): a late measurement merged since that solve shifts
        positions, so positional alignment would difference states at
        DIFFERENT time points.  Points with no previous estimate (just
        merged) carry no residual signal and are skipped.  No previous
        window (first solve) = no signal.
        """
        if track.win_x is None:
            return
        prev_ts, prev_x = track.win_ts, track.win_x
        idx = np.searchsorted(prev_ts, evicted_ts)
        found = idx < prev_ts.shape[0]
        found &= prev_ts[np.minimum(idx, prev_ts.shape[0] - 1)] == evicted_ts
        if not found.any():
            return
        delta = float(np.max(np.abs(evicted_x[found] - prev_x[idx[found]])))
        track.last_evict_delta = delta
        if obs.enabled():
            obs.record("stream.evict_delta", delta)
        target = self.committed_error_target
        if target is None:
            return
        old = self.lag
        if delta > target:
            self.lag = min(self.lag_max, self.lag + 1)
        elif delta < target * _LAG_SHRINK_RATIO:
            self.lag = max(self.lag_min, self.lag - 1)
        if self.lag != old:
            self.lag_adjustments += 1
            if obs.enabled():
                obs.inc("stream.lag_adjustments")
                obs.set_gauge("stream.lag", self.lag)

    def _trim_committed(self, track: _Track) -> None:
        """Enforce ``max_committed_states``: drop the OLDEST committed
        states past the cap (caller holds lock)."""
        cap = self.max_committed_states
        if cap is None:
            return
        excess = sum(a.shape[0] for a in track.committed_x) - cap
        if excess <= 0:
            return
        track.trimmed += excess
        if obs.enabled():
            obs.inc("stream.committed_trimmed", excess)
        while excess > 0:
            head = track.committed_x[0].shape[0]
            if head <= excess:
                del track.committed_x[0]
                del track.committed_S[0]
                del track.committed_v[0]
                excess -= head
            else:
                track.committed_x[0] = track.committed_x[0][excess:]
                track.committed_S[0] = track.committed_S[0][excess:]
                track.committed_v[0] = track.committed_v[0][excess:]
                excess = 0
