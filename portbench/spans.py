"""What the port's own ranges say about the profiled stretch.

The port marks each layer of a wave and of its solve with a range on the
profiler's timeline (``repro_torch.obs.tracing.trace_range``, taxonomy in
that module's docstring): ``engine.step`` holds ``engine.pack``,
``estimator.solve`` (which holds the ``solve.*`` ranges) and
``engine.slice``.  In a :class:`profiling.Profile` they are the host
events named under ``ROOTS``; the harness's own ``portbench.*`` ranges
are not among them.

Three readings:

* device seconds by the innermost range open when each operation was
  launched (``OUTSIDE`` if none was);
* idle seconds by the innermost range open at each gap's middle;
* host waits: calls that block the host until the card has caught up
  (``WAITS``, or a copy call whose device copy is ``Memcpy DtoH``).

A ``Profile`` keeps no link between a device operation and the host call
that launched it.  The port queues its work on one stream, where the card
runs the operations in the order of their calls, so the stretch's launch
calls in the host's order and its operations in the device's order are
one sequence, once the calls whose operations the profile lacks are set
aside.  Those are the first few after the profiler starts (1 to 14 calls
on the H100, all made before the first operation the profile holds), and
any at the end whose operation the device's clock puts past the stretch.
Which calls those are follows from the kinds: the sequence of kinds
(kernel, copy, fill) of the operations must be that of the calls with
the lost ones left out.  Where no such cut, or more than one, fits,
nothing is paired, the device readings find nothing, and a line on
stderr says so.

The card's clock drifts from the host's in the trace, by up to ~1 us a
ms on the H100 (~2 ms over a stretch).  So nothing here compares a
device time with a host time across the stretch: an operation goes to
its call's range, and an idle gap to the range open on the host when the
call that ended the gap was made, less half the gap.
"""
from __future__ import annotations

import collections
import sys
from typing import Dict, List, Optional, Tuple

ROOTS = ("engine.", "estimator.", "solve.")
SOLVE = "estimator.solve"
OUTSIDE = "outside the program"
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")
KERNEL_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                "cudaLaunchCooperativeKernel", "cuLaunchKernel",
                "cuLaunchKernelEx", "cuLaunchCooperativeKernel")
DTOH = "Memcpy DtoH"


def call_kind(name: str) -> Optional[str]:
    """The kind of device operation a host call launches, if it launches
    one."""
    if name in KERNEL_CALLS:
        return "kernel"
    if name.startswith(("cudaMemcpy", "cuMemcpy")):
        return "copy"
    if name.startswith(("cudaMemset", "cuMemset")):
        return "fill"
    return None


def op_kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "copy"
    if name.startswith("Memset"):
        return "fill"
    return "kernel"


class Stretch:
    """One profiled stretch seen through the port's ranges.

    ``ranges`` are the program's ranges ``(start_us, end_us, name)``;
    ``pairs`` pairs each device operation ``(name, start_us, end_us)``
    with the host call that launched it, ``((name, start, end), op)``, in
    the calls' order, or is ``None`` where the stretch cannot be paired
    (see the module's docstring); ``launched_in`` holds, for each pair,
    the names of the ranges open at its call, outermost first; ``waits``
    are the host calls that waited for the card, with ``waited_in``
    likewise.
    """

    def __init__(self, profile):
        self.profile = profile
        cpu = profile._cpu
        self.ranges = sorted(((a, b, n) for n, a, b in cpu
                              if n.startswith(ROOTS)),
                             key=lambda r: (r[0], -r[1]))
        calls = sorted((e for e in cpu if profile.t0 <= e[1] <= profile.t1),
                       key=lambda e: e[1])
        self.pairs = self._pair(calls)
        self.launched_in = self.open_at([c[1] for c, _ in self.pairs or ()])
        dtoh = {c for c, op in self.pairs or () if op[0].startswith(DTOH)}
        self.waits = [c for c in calls if c[0] in WAITS or c in dtoh]
        self.waited_in = self.open_at([c[1] for c in self.waits])

    def _pair(self, calls) -> Optional[list]:
        made = [c for c in calls if call_kind(c[0])]
        ran = sorted(self.profile.ops, key=lambda o: o[1])
        said = "".join(call_kind(c[0])[0] for c in made)
        seen = "".join(op_kind(o[0])[0] for o in ran)
        fits = [h for h in range(len(made) - len(ran) + 1)
                if said.startswith(seen, h)]
        if len(fits) != 1:
            print(f"portbench.spans: {len(fits)} ways to pair "
                  f"{len(made)} launch calls with {len(ran)} device "
                  f"operations; the device readings by range are left out",
                  file=sys.stderr)
            return None
        return list(zip(made[fits[0]:], ran))

    def open_at(self, times: List[float]) -> List[Tuple[str, ...]]:
        """For each of the ascending ``times``, the names of the ranges
        open then, outermost first."""
        out, stack, i = [], [], 0
        for t in times:
            while i < len(self.ranges) and self.ranges[i][0] <= t:
                a, b, n = self.ranges[i]
                while stack and stack[-1][1] < a:
                    stack.pop()
                stack.append((a, b, n))
                i += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            out.append(tuple(n for a, b, n in stack if a <= t <= b))
        return out

    # -- the three readings ---------------------------------------------

    def device_by_span(self) -> Optional[Dict[str, float]]:
        """Device seconds by the innermost range open at each operation's
        launch, most first; ``None`` where nothing could be paired."""
        if self.pairs is None:
            return None
        acc = collections.Counter()
        for (_, op), names in zip(self.pairs, self.launched_in):
            acc[names[-1] if names else OUTSIDE] += (op[2] - op[1]) / 1e6
        return dict(acc.most_common())

    def idle_by_span(self) -> Dict[str, float]:
        """Idle seconds by the innermost range open at each gap's middle
        on the host's clock (the start of the call that ended the gap,
        less half the gap; the device's clock where no paired call ended
        it), most first."""
        p = self.profile
        edges = [p.t0] + [x for ab in p.busy for x in ab] + [p.t1]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        ended = {op[1]: c[1] for c, op in self.pairs or ()}
        mids = [ended.get(b, b) - 0.5 * (b - a) for a, b in gaps]
        order = sorted(range(len(gaps)), key=mids.__getitem__)
        acc = collections.Counter()
        for i, names in zip(order, self.open_at([mids[i] for i in order])):
            a, b = gaps[i]
            acc[names[-1] if names else OUTSIDE] += (b - a) / 1e6
        return dict(acc.most_common())

    def waits_by_span(self) -> Dict[str, List[float]]:
        """``{range: [count, seconds]}`` of the host's waits by the
        innermost range open at each wait's start."""
        acc: Dict[str, List[float]] = {}
        for c, names in zip(self.waits, self.waited_in):
            slot = acc.setdefault(names[-1] if names else OUTSIDE, [0, 0.0])
            slot[0] += 1
            slot[1] += (c[2] - c[1]) / 1e6
        return acc

    # -- per solve --------------------------------------------------------

    def solves(self) -> int:
        """The number of outermost ``estimator.solve`` ranges."""
        n, end = 0, -1.0
        for a, b, name in self.ranges:
            if name == SOLVE and a > end:
                n, end = n + 1, b
        return n

    def host_seconds(self, name: str) -> float:
        """Host seconds inside the ranges named ``name`` (nested ones of
        the same name counted once)."""
        total, end = 0.0, -1.0
        for a, b, n in self.ranges:
            if n == name and b > end:
                total += b - max(a, end)
                end = b
        return total / 1e6

    def waits_in(self, name: str) -> Tuple[int, float]:
        """The host's waits that start inside a range named ``name``:
        their count and the host seconds they blocked."""
        hits = [c for c, names in zip(self.waits, self.waited_in)
                if name in names]
        return len(hits), sum(c[2] - c[1] for c in hits) / 1e6

    def device_seconds_in(self, names: Tuple[str, ...]) -> Optional[float]:
        """Device seconds of the operations launched inside a range named
        in ``names``; ``None`` where the stretch has no such range or
        nothing could be paired."""
        if not self.pairs or not any(n in names for _, _, n in self.ranges):
            return None
        return sum(op[2] - op[1]
                   for (_, op), opened in zip(self.pairs, self.launched_in)
                   if any(n in names for n in opened)) / 1e6


def stretch(ctx) -> Optional[Stretch]:
    """The traced run's stretch, if it holds an ``estimator.solve`` range
    (read once a run: kept on ``ctx``)."""
    if ctx.profile is None:
        return None
    s = getattr(ctx, "spans_stretch", None)
    if s is None or s.profile is not ctx.profile:
        s = ctx.spans_stretch = Stretch(ctx.profile)
    return s if s.solves() else None


def per_solve_ms(ctx, value) -> Optional[float]:
    """``value(stretch)`` in seconds, per ``estimator.solve`` range of the
    stretch, in ms; ``None`` where the stretch has none or the value is
    ``None``."""
    s = stretch(ctx)
    if s is None:
        return None
    v = value(s)
    return None if v is None else v / s.solves() * 1e3
