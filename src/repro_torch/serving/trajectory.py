"""Trajectory-estimation serving engine: MAP solves as a batched service.

``TrajectoryEngine`` is the estimation-workload sibling of
:class:`~repro_torch.serving.engine.ServeEngine`: it serves
:class:`~repro_torch.core.Problem` solves through one
:class:`~repro_torch.core.Estimator` (the counterpart of the reference's
``repro/serving/trajectory.py``):

* **fixed-batch waves** -- every wave is exactly ``batch`` rows, one
  stacked solve (one scan-kernel launch per backward scan with
  ``method="parallel_kernel"``);
* **pad-and-bucket** -- ragged record lengths are padded to power-of-two
  block counts with masked measurements (exact, see
  :mod:`repro_torch.core.padding`);
* **row recycling / continuous batching** -- short waves are topped up by
  recycling a live row, and the queue is drained in FIFO waves grouped by
  bucket (the wave machinery is shared with
  :class:`~repro_torch.serving.StreamingEngine`, see
  :mod:`repro_torch.serving.waves`).

API: ``submit(ts, y) -> ticket``; ``step()`` solves one wave; ``collect()``
pops finished ``(ticket, Solution)`` pairs (``collect(tickets=...)``
pops only YOUR tickets); ``estimate(records)`` is the synchronous
convenience wrapper.  Solutions live on the estimator's device, as
:meth:`Estimator.solve`'s do.

The solver configuration is the Estimator's: ``method=`` plus the method's
options dataclass.  The pre-redesign kwargs (``nsub``/``mode``/
``iterations``/``divergence_correction``) are still accepted with a
``DeprecationWarning``.  ``device`` defaults to ``"cuda"`` and raises
without a card unless ``device="cpu"`` is passed.  ``mesh``/``batch_axis``
go to the Estimator: each wave's rows are split over the mesh's batch
axis (and, with ``method="distributed"``, each row's time axis over its
time axis).
"""
from __future__ import annotations

import collections
import threading
import time
import warnings
from typing import Deque, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch import obs
from repro_torch.core.estimator import Estimator, Problem, legacy_options
from repro_torch.core.padding import bucket_length, slice_solution
from repro_torch.core.sde import LinearSDE, NonlinearSDE
from repro_torch.core.types import Solution

from .waves import (
    WaveItem,
    pack_wave,
    record_wave_metrics,
    robust_default_options,
    take_wave,
    validate_record,
)


def check_wave_batch(estimator: Estimator, batch: int) -> None:
    """A wave of ``batch`` rows must split evenly over the mesh's batch
    axis."""
    shard = estimator._batch_shard_size(estimator._resolved_mesh())
    if batch % shard:
        raise ValueError(
            f"batch {batch} not divisible by mesh batch axis size {shard}")


class TrajectoryEngine:
    """Queued, batched MAP-estimation service for one model.

    Args:
      model: shared :class:`LinearSDE` / :class:`NonlinearSDE`.
      batch: fixed wave size.
      method: registered method name; ``options`` its options dataclass
        -- both forwarded to the underlying :class:`Estimator`.
        ``options=None`` uses the method's defaults with the ``discrete``
        element mode (see
        :func:`repro_torch.serving.waves.robust_default_options`).
      bucket_sizes: optional explicit padded-length buckets (multiples of
        the method's block size); default is power-of-two block counts.
      device: where the waves are solved; ``None`` means ``"cuda"`` (or
        the mesh's first device).
      mesh / batch_axis: forwarded to the :class:`Estimator` (a
        :class:`~repro_torch.distributed.MeshSpec` or ``Mesh``); ``batch``
        must be a multiple of the mesh's batch axis.

    ``submit``/``collect`` are thread-safe (one lock guards the queue and
    the finished map); ``step``/``run`` may be driven from a dedicated
    solver thread while clients submit and collect concurrently.
    """

    def __init__(
        self,
        model: Union[LinearSDE, NonlinearSDE],
        *,
        batch: int = 8,
        method: str = "parallel_rts",
        options=None,
        bucket_sizes: Optional[Sequence[int]] = None,
        device=None,
        mesh=None,
        batch_axis: str = "data",
        **legacy,
    ):
        if legacy:
            allowed = {"nsub", "mode", "iterations", "divergence_correction"}
            unknown = set(legacy) - allowed
            if unknown:
                raise TypeError(
                    f"unexpected keyword arguments: {sorted(unknown)}")
            if options is not None:
                raise TypeError(
                    "pass either options=... or the legacy kwargs "
                    f"{sorted(legacy)}, not both")
            warnings.warn(
                f"TrajectoryEngine kwargs {sorted(legacy)} are deprecated; "
                "pass the method's options dataclass via options=",
                DeprecationWarning, stacklevel=2)
            options = legacy_options(model, method, **legacy)
        elif options is None:
            options = robust_default_options(method)
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        self.estimator = Estimator(model, method=method, options=options,
                                   device=device, mesh=mesh,
                                   batch_axis=batch_axis)
        check_wave_batch(self.estimator, batch)
        self.model = model
        self.batch = batch
        self.bucket_sizes = bucket_sizes

        self._lock = threading.Lock()
        self._queue: Deque[WaveItem] = collections.deque()
        self._done: Dict[int, Solution] = {}
        self._next_ticket = 0
        self.waves = 0            # stacked solves issued
        self.recycled_rows = 0    # padding rows recycled into short waves

    # -- submit / collect ---------------------------------------------------

    def submit(self, ts, y) -> int:
        """Enqueue one record; returns a ticket redeemable at collect().

        Validates shapes AND that ``ts`` is strictly increasing -- padding
        extrapolates the grid with the final step size, so a non-monotone
        grid would otherwise silently produce a broken padded problem.
        """
        ts, y = validate_record(ts, y)
        n_pad = bucket_length(y.shape[0], self.estimator.block_size,
                              self.bucket_sizes)
        with self._lock:
            ticket = self._next_ticket
            self._next_ticket += 1
            self._queue.append(
                WaveItem(ticket, ts, y, n_pad, time.perf_counter()))
            depth = len(self._queue)
        if obs.enabled():
            obs.inc("engine.submitted")
            obs.set_gauge("engine.queue_depth", depth)
        return ticket

    def pending(self) -> int:
        return len(self._queue)

    def collect(
        self, tickets: Optional[Sequence[int]] = None,
    ) -> List[Tuple[int, Solution]]:
        """Pop finished ``(ticket, solution)`` pairs, ticket order.

        With ``tickets=None`` pops EVERY finished pair (single-consumer
        mode).  ``tickets=[...]`` pops only those tickets that are
        finished, leaving everything else for other collectors.  Tickets
        that are unknown, still pending, or already collected are simply
        not returned; use :meth:`describe_ticket` for a diagnosis.
        """
        with self._lock:
            if tickets is None:
                out = sorted(self._done.items())
                self._done.clear()
            else:
                out = sorted((t, self._done.pop(t))
                             for t in set(tickets) if t in self._done)
        return out

    def describe_ticket(self, ticket: int) -> str:
        """Human-readable state of a ticket (for error messages)."""
        with self._lock:
            if ticket in self._done:
                return "finished (awaiting collect)"
            if any(item.key == ticket for item in self._queue):
                return "queued (not yet solved; call step()/run())"
            if 0 <= ticket < self._next_ticket:
                return "already collected (results are popped exactly once)"
            return f"never issued (tickets so far: 0..{self._next_ticket - 1})"

    # -- wave processing ----------------------------------------------------

    def step(self) -> int:
        """Solve one fixed-size wave; returns the number of requests
        completed (0 if the queue is empty).

        With :mod:`repro_torch.obs` enabled each wave reports occupancy,
        padding waste, queue depth and per-record submit-to-done latency
        (``engine.record_latency_seconds``; the estimator's measured path
        waits for the card, so the latency covers the solve)."""
        with self._lock:
            if not self._queue:
                return 0
            wave = take_wave(self._queue, self.batch)
            depth = len(self._queue)
        with obs.trace_span("engine.step"):
            n_pad = wave[0].n_pad
            ts_b, ys_b, mask_b, _, _ = pack_wave(
                wave, self.batch, device=self.estimator.device,
                dtype=self.estimator._model.dtype)
            sol = self.estimator.solve(
                Problem.stacked(self.model, ts_b, ys_b,
                                measurement_mask=mask_b))
            done = {item.key: slice_solution(sol, row, item.y.shape[0])
                    for row, item in enumerate(wave)}
            with self._lock:
                self._done.update(done)
                self.waves += 1
                self.recycled_rows += self.batch - len(wave)
            if obs.enabled():
                record_wave_metrics("engine", wave, n_pad, self.batch, depth)
        return len(wave)

    def run(self) -> int:
        """Drain the queue; returns the total number of requests solved.

        With :mod:`repro_torch.obs` enabled, sets ``engine.tracks_per_sec``
        (drain throughput of this call)."""
        total = 0
        t0 = time.perf_counter()
        with obs.trace_span("engine.run"):
            while self._queue:
                total += self.step()
        dt = time.perf_counter() - t0
        if total and dt > 0:
            obs.set_gauge("engine.tracks_per_sec", total / dt)
        return total

    # -- synchronous convenience --------------------------------------------

    def estimate(self, records: Sequence[Tuple]) -> List[Solution]:
        """Submit ``(ts, y)`` records, drain, return solutions in order.

        Collects ONLY its own tickets, so concurrent ``collect()`` /
        ``estimate()`` callers cannot steal these results.  If a ticket
        still cannot be redeemed the error says why.
        """
        tickets = [self.submit(ts, y) for ts, y in records]
        self.run()
        got = dict(self.collect(tickets=tickets))
        missing = [t for t in tickets if t not in got]
        if missing:
            states = ", ".join(
                f"ticket {t}: {self.describe_ticket(t)}" for t in missing)
            raise KeyError(
                f"estimate() could not redeem {len(missing)} ticket(s) -- "
                f"{states}")
        return [got[t] for t in tickets]
