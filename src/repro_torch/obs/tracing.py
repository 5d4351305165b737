"""Wall-time span trees: ``trace_span("estimator.solve.execute")``, and
ranges on the ``torch.profiler`` timeline: ``trace_range("solve.fill")``.

Spans nest per-thread; a completed ROOT span (no open parent on this
thread) is appended to a bounded ring, readable via :func:`span_trees`.
Every span additionally records its duration into the histogram
``span.<name>`` so :func:`repro_torch.obs.snapshot` reports per-phase
percentiles without walking trees.

Both put their name on the profiler's timeline (the reference's
``xla=True`` and ``xla_profile`` in PyTorch's wording):

* :func:`trace_range` opens ``torch.profiler.record_function(name)``
  while a profiler is recording and does nothing otherwise, whatever
  :func:`repro_torch.obs.enabled` says: no span, no histogram, no
  synchronise, no tensor.  The program marks its layer boundaries with
  it (below).
* ``trace_span`` labels its body the same way whenever a profiler
  records, with telemetry on or off; its ``record_function`` argument is
  kept for parity with the reference's ``xla`` and changes nothing.
* :func:`torch_profile` brackets a block with a ``torch.profiler.profile``
  of the CPU and (where there is a card) CUDA activity and writes a Chrome
  trace into ``logdir``.

A span and a range measure host time.  Work queued on the card runs
asynchronously and is not covered by either: the device time of the work
launched inside a range comes from the profiler's trace, which pairs each
device operation with the call that launched it, never from a
synchronise inside the range.  ``Estimator.solve``'s measured path (with
telemetry on) synchronises after the solve for its own phase timing.

The ranges at the layer boundaries of a wave and its solve (a range is
never a ``span.<name>`` histogram)::

    engine.step             one TrajectoryEngine wave (a trace_span)
    |- engine.pack          pack_wave: host pad + stack, host-to-device copies
    |- estimator.solve      Estimator.solve, hot and measured paths (measured:
    |  |                    under estimator.solve.execute / .compile)
    |  |- solve.grid        linear grid (grid_lqt_from_linear)
    |  |- solve.linearise   Taylor linearisation, once a pass (nonlinear models)
    |  |- solve.elements    block elements, terminal element, append
    |  |- solve.scan        the eq.-(42) suffix scan over the block elements
    |  |- solve.fill        in-block values, values_full assembly
    |  |- solve.recover     trajectory recovery (eq. 47) and the flips
    |  `- solve.cost        OM cost; in an iterated solve each pass's cost and
    |                       step norm, then the traces' stack
    `- engine.slice         slice_solution per record, bookkeeping

The linear OM cost factors ``Q`` once a solve when the model's ``Q`` is
a constant tensor, and on every grid point when it is a callable of t.
While telemetry and ``diagnostics`` are on, each linear solve counts
which it took, one of two counters (beside ``estimator.solves``)::

    cost.qpinv.once         Q's pseudo-inverse taken once and broadcast
    cost.qpinv.grid         one pseudo-inverse per grid point (callable Q)

The suffix scan's kernel is ``lqt_scan_kernel`` on the trace for states
up to 8 wide and ``lqt_scan_wide_kernel`` (one launch per tree level)
above; each kernel counts its launches on the card, where they are made,
while telemetry is on (a CPU tensor's plain scan launches nothing)::

    scan.kernel.regs        launches of the register kernel (one a scan)
    scan.kernel.wide        launches of the wide kernel (as it reports them)

The ``Solution``'s copies at the end of the solve sit in
``estimator.solve`` outside any ``solve.*`` range.  A Wiener wave of
``parallel_kernel`` opens 10 ranges; an iterated solve of 5 passes
repeats ``solve.linearise`` .. ``solve.cost`` five times (35 in a
coordinated-turn wave).  The benchmark's ``portbench/spans.py`` reads
them in its profiled stretch.
"""
from __future__ import annotations

import collections
import contextlib
import os
import sys
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


_NO_RANGE = contextlib.nullcontext()


def trace_range(name: str):
    """A range named ``name`` on the timeline of the ``torch.profiler``
    that is recording, if one is (``torch.profiler.record_function``);
    else a shared no-op context.  Never a span, a metric, a synchronise
    or a tensor.  Reads torch's own flag, and loads nothing where torch
    is not loaded."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is None or not prof._is_profiler_enabled:
        return _NO_RANGE
    return prof.record_function(name)


@contextmanager
def trace_span(name: str, record_function: bool = False):
    """Time a region as a span under the current thread's open span (if
    any).  While a profiler records, the region is also a
    :func:`trace_range` of the same name, with telemetry on or off;
    ``record_function`` is accepted for parity with the reference's
    ``xla`` and changes nothing.  No span or metric while obs is
    disabled."""
    if not metrics.enabled():
        with trace_range(name):
            yield None
        return
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    span = Span(name)
    parent: Optional[Span] = stack[-1] if stack else None
    stack.append(span)
    try:
        with trace_range(name):
            yield span
    finally:
        span.dur_s = time.perf_counter() - span.t0
        if stack and stack[-1] is span:
            stack.pop()
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
