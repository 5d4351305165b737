"""Process-local, thread-safe metrics registry.

Three instrument kinds, all named by dot-separated strings (taxonomy in
``docs/OBSERVABILITY.md``):

* :class:`Counter`   -- monotone int (``cache.hits``, ``engine.completed``);
* :class:`Gauge`     -- last-write-wins float (``engine.queue_depth``);
* :class:`Histogram` -- fixed geometric buckets with count/sum/min/max and
  p50/p90/p99 readout (``engine.record_latency_seconds``).

The PyTorch port's copy of the reference registry (``repro/obs/metrics.py``):
the same instruments, buckets, percentile rule and snapshot.

Design constraints (why this looks the way it does):

* **Zero overhead when disabled.**  Recording is gated on one module-level
  bool; every convenience helper (:func:`inc`, :func:`record`,
  :func:`set_gauge`) checks it first and returns immediately, allocating
  nothing.  The registry starts DISABLED unless the ``REPRO_OBS``
  environment variable is truthy; benchmarks and tests call
  :func:`enable` explicitly.
* **Scalars only.**  Every recorded value goes through ``float()``; a
  0-d tensor is read with one ``.item()`` (a device sync on the card, so
  instrumented code records tensors only on its measured path).  Values
  that refuse concretisation -- tensors of more than one element,
  ``torch.func`` batched tensors under ``vmap`` -- are dropped and tallied
  in ``snapshot()["dropped_records"]``, never captured.
* **Thread-safe.**  One registry lock serialises all mutation
  (``TrajectoryEngine`` submit/collect runs from client threads).

This module imports neither ``torch`` nor anything else heavy: it must
be importable (and near-free) in processes that never touch a card.
"""
from __future__ import annotations

import bisect
import contextlib
import math
import os
import threading
from typing import Dict, List, Optional, Sequence


def _default_buckets() -> List[float]:
    """Geometric bucket edges covering 1e-7 .. 1e3 (3 per decade): wide
    enough for seconds-scale latencies down to sub-microsecond spans."""
    return [10.0 ** (e / 3.0) for e in range(-21, 10)]


class Counter:
    """Monotone counter.  ``inc`` only; never decreases."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str, lock: threading.RLock) -> None:
        self.name = name
        self.value = 0
        self._lock = lock

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += int(n)


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str, lock: threading.RLock) -> None:
        self.name = name
        self.value = 0.0
        self._lock = lock

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)


class Histogram:
    """Fixed-bucket histogram with percentile readout.

    Bucket ``i`` counts values in ``(edges[i-1], edges[i]]`` (bucket 0 is
    ``<= edges[0]``, the last bucket is overflow).  Percentiles are read
    back by linear interpolation across the covering bucket's edges and
    clamped to the exact observed ``[min, max]`` -- coarse by design
    (fixed memory, O(1) record) but accurate to a bucket width.
    """

    __slots__ = ("name", "edges", "counts", "count", "sum", "min", "max",
                 "_lock")

    def __init__(self, name: str, lock: threading.RLock,
                 buckets: Optional[Sequence[float]] = None) -> None:
        self.name = name
        self.edges = sorted(float(b) for b in (buckets or _default_buckets()))
        self.counts = [0] * (len(self.edges) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._lock = lock

    def record(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.counts[bisect.bisect_left(self.edges, v)] += 1
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    def percentile(self, q: float) -> float:
        """Estimate the ``q``-quantile (``0 <= q <= 1``) from the buckets."""
        with self._lock:
            if not self.count:
                return math.nan
            target = q * self.count
            seen = 0.0
            for i, c in enumerate(self.counts):
                if seen + c >= target and c:
                    lo = self.edges[i - 1] if i > 0 else min(self.min, 0.0)
                    hi = self.edges[i] if i < len(self.edges) else self.max
                    frac = (target - seen) / c
                    est = lo + frac * (hi - lo)
                    return min(max(est, self.min), self.max)
                seen += c
            return self.max

    def summary(self) -> Dict[str, float]:
        with self._lock:
            if not self.count:
                return {"count": 0}
            return {
                "count": self.count,
                "sum": self.sum,
                "mean": self.sum / self.count,
                "min": self.min,
                "max": self.max,
                "p50": self.percentile(0.50),
                "p90": self.percentile(0.90),
                "p99": self.percentile(0.99),
            }


class Registry:
    """Create-or-get store for named instruments."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self.dropped_records = 0   # values refusing float(), see record()

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name, self._lock)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name, self._lock)
            return g

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(
                    name, self._lock, buckets)
            return h

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self.dropped_records = 0

    def is_empty(self) -> bool:
        with self._lock:
            return not (self._counters or self._gauges or self._histograms)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": {k: c.value
                             for k, c in sorted(self._counters.items())},
                "gauges": {k: g.value
                           for k, g in sorted(self._gauges.items())},
                "histograms": {k: h.summary()
                               for k, h in sorted(self._histograms.items())},
                "dropped_records": self.dropped_records,
            }


REGISTRY = Registry()

_ENABLED = os.environ.get("REPRO_OBS", "").lower() in ("1", "true", "yes")


def enable() -> None:
    """Turn recording on (process-wide)."""
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    """Turn recording off; helpers become no-ops, nothing is allocated."""
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


def reset() -> None:
    """Drop every instrument and recorded value (keeps the enabled flag)."""
    REGISTRY.reset()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str,
              buckets: Optional[Sequence[float]] = None) -> Histogram:
    return REGISTRY.histogram(name, buckets)


def _concretise(v) -> Optional[float]:
    """``float(v)`` (``v.item()`` for a tensor or numpy scalar) or ``None``
    for values that refuse concretisation -- a tensor of more than one
    element, a batched tensor under ``torch.func.vmap``.  Dropping (instead
    of raising) guarantees obs can never break the code it measures."""
    try:
        if not isinstance(v, (int, float)) and hasattr(v, "item"):
            v = v.item()
        return float(v)
    except Exception:
        with REGISTRY._lock:
            REGISTRY.dropped_records += 1
        return None


def inc(name: str, n: int = 1) -> None:
    """Increment counter ``name`` (no-op when disabled)."""
    if _ENABLED:
        REGISTRY.counter(name).inc(n)


class _Replay(threading.local):
    active = False


_REPLAY = _Replay()


@contextlib.contextmanager
def replaying():
    """Mark the calling thread as re-running a cached solve (an executable
    cache entry after its first run): :func:`inc_per_entry` counts nothing
    inside."""
    prev, _REPLAY.active = _REPLAY.active, True
    try:
        yield
    finally:
        _REPLAY.active = prev


def inc_per_entry(name: str, n: int = 1) -> None:
    """Increment counter ``name`` unless a cached solve is replaying
    (:func:`replaying`): a cache entry counts on its first run only, as
    the reference counts these while it traces a new executable.  Code run
    outside a cache entry counts every call."""
    if _ENABLED and not _REPLAY.active:
        REGISTRY.counter(name).inc(n)


def set_gauge(name: str, v) -> None:
    """Set gauge ``name`` (no-op when disabled; non-scalars dropped)."""
    if _ENABLED:
        f = _concretise(v)
        if f is not None:
            REGISTRY.gauge(name).set(f)


def record(name: str, v,
           buckets: Optional[Sequence[float]] = None) -> None:
    """Record ``v`` into histogram ``name`` (no-op when disabled;
    non-scalars dropped)."""
    if _ENABLED:
        f = _concretise(v)
        if f is not None:
            REGISTRY.histogram(name, buckets).record(f)
