"""Wall-time span trees: ``trace_span("estimator.solve.execute")``.

Spans nest per-thread; a completed ROOT span (no open parent on this
thread) is appended to a bounded ring, readable via :func:`span_trees`.
Every span additionally records its duration into the histogram
``span.<name>`` so :func:`repro_torch.obs.snapshot` reports per-phase
percentiles without walking trees.

Two profiler passthroughs connect host spans to device profiles (the
reference's ``xla=True`` and ``xla_profile`` in PyTorch's wording):

* ``trace_span(name, record_function=True)`` wraps the body in
  ``torch.profiler.record_function(name)`` so the span shows up as a
  labelled range on the host timeline of a ``torch.profiler`` trace;
* :func:`torch_profile` brackets a block with a ``torch.profiler.profile``
  of the CPU and (where there is a card) CUDA activity and writes a Chrome
  trace into ``logdir``.

A span measures host wall time.  Work queued on the card runs
asynchronously, so code that wants a span to cover device work
synchronises inside it (``Estimator.solve`` does on its measured path).
"""
from __future__ import annotations

import collections
import os
import threading
import time
from contextlib import contextmanager
from typing import List, Optional

from . import metrics

_MAX_ROOTS = 64
_roots: "collections.deque" = collections.deque(maxlen=_MAX_ROOTS)
_roots_lock = threading.Lock()
_local = threading.local()


class Span:
    """One timed region: name, start, duration, child spans."""

    __slots__ = ("name", "t0", "dur_s", "children")

    def __init__(self, name: str) -> None:
        self.name = name
        self.t0 = time.perf_counter()
        self.dur_s = 0.0
        self.children: List["Span"] = []

    def as_dict(self) -> dict:
        d = {"name": self.name, "dur_s": self.dur_s}
        if self.children:
            d["children"] = [c.as_dict() for c in self.children]
        return d


@contextmanager
def trace_span(name: str, record_function: bool = False):
    """Time a region as a span under the current thread's open span (if
    any); ``record_function`` also labels it for ``torch.profiler``.
    No-op (and allocation-free) while obs is disabled."""
    if not metrics.enabled():
        yield None
        return
    ann = None
    if record_function:
        import torch

        ann = torch.profiler.record_function(name)
        ann.__enter__()
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    span = Span(name)
    parent: Optional[Span] = stack[-1] if stack else None
    stack.append(span)
    try:
        yield span
    finally:
        span.dur_s = time.perf_counter() - span.t0
        if stack and stack[-1] is span:
            stack.pop()
        if ann is not None:
            ann.__exit__(None, None, None)
        if parent is not None:
            parent.children.append(span)
        else:
            with _roots_lock:
                _roots.append(span)
        metrics.record(f"span.{name}", span.dur_s)


def span_trees() -> List[dict]:
    """The most recent completed root spans (oldest first) as nested
    ``{"name", "dur_s", "children"}`` dicts."""
    with _roots_lock:
        return [s.as_dict() for s in _roots]


def reset() -> None:
    with _roots_lock:
        _roots.clear()


@contextmanager
def torch_profile(logdir: str):
    """Profile a block with ``torch.profiler`` (CPU activity, plus CUDA
    where a card is present) and write its Chrome trace to
    ``logdir/trace.json``.  Spans entered with ``record_function=True``
    inside the block appear on the trace's host timeline.  Yields the
    profiler object, for ``key_averages()``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
