"""What one ``torch.profiler`` stretch of the traced run says: the device's
operations, its busy time, and what the host was doing while it idled.

The stretch runs from the start of the first to the end of the last
``portbench.wave`` range (the harness's label of one closed-loop wave:
submit, step, collect); every wave ends by copying its trajectories to the
host, so the device work of the stretch lies inside it.
"""
from __future__ import annotations

import collections
from typing import List, Optional, Tuple

import numpy as np

MARKER = "portbench.wave"
TOP = 10


def _merge(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Profile:
    """Device operations ``(name, start_us, end_us)`` inside the stretch,
    and the host events around them.

    Built from plain tuples so that it can be read without a card:
    ``cpu`` and ``device`` are ``(name, start_us, end_us)`` in the
    profiler's one time base.  Device events that carry a host range's
    name are the profiler's device-side copies of ``record_function``
    ranges, not operations, and are dropped.
    """

    def __init__(self, cpu: list, device: list):
        names = {n for n, _, _ in cpu}
        marks = [(a, b) for n, a, b in cpu if n == MARKER]
        if not marks:
            raise ValueError(f"no {MARKER!r} range in the profile")
        self.t0 = min(a for a, _ in marks)
        self.t1 = max(b for _, b in marks)
        self.window_s = (self.t1 - self.t0) / 1e6
        self.ops = [(n, max(a, self.t0), min(b, self.t1))
                    for n, a, b in device
                    if n not in names and b > self.t0 and a < self.t1]
        self.busy = _merge([(a, b) for _, a, b in self.ops])
        self.busy_s = sum(b - a for a, b in self.busy) / 1e6
        self._cpu = [(n, a, b) for n, a, b in cpu if n != MARKER]

    @classmethod
    def from_profiler(cls, prof) -> "Profile":
        from torch.autograd import DeviceType

        cpu, device = [], []
        for e in prof.events():
            if getattr(e, "is_user_annotation", False) and (
                    e.device_type != DeviceType.CPU):
                continue
            row = (e.name, float(e.time_range.start), float(e.time_range.end))
            (cpu if e.device_type == DeviceType.CPU else device).append(row)
        return cls(cpu, device)

    def device_seconds(self, contains: str) -> float:
        """Summed time of the device operations whose name holds
        ``contains``."""
        return sum(b - a for n, a, b in self.ops if contains in n) / 1e6

    def top_ops(self) -> list:
        """``[[name, seconds], ...]``: the device operations that took the
        most time, summed by name."""
        acc = collections.Counter()
        for n, a, b in self.ops:
            acc[n[:120]] += (b - a) / 1e6
        return [[n, s] for n, s in acc.most_common(TOP)]

    def idle_gaps(self) -> list:
        """``[[label, seconds], ...]``: the device's idle time in the
        stretch, summed by what the host was doing at each gap's middle
        (the harness's range, then the innermost host event), most first."""
        edges = [self.t0] + [x for ab in self.busy for x in ab] + [self.t1]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        if not self._cpu:
            return []
        names = [n for n, _, _ in self._cpu]
        start = np.array([a for _, a, _ in self._cpu])
        end = np.array([b for _, _, b in self._cpu])
        outer = np.array([n.startswith("portbench.") for n in names])
        acc = collections.Counter()
        for a, b in gaps:
            t = 0.5 * (a + b)
            inside = (start <= t) & (end >= t)
            acc[self._label(names, start, end, outer, inside)] += (b - a) / 1e6
        return [[n, s] for n, s in acc.most_common(TOP)]

    @staticmethod
    def _label(names, start, end, outer, inside) -> str:
        def innermost(mask) -> Optional[str]:
            idx = np.flatnonzero(mask)
            if idx.size == 0:
                return None
            return names[idx[np.argmin(end[idx] - start[idx])]]

        o = innermost(inside & outer) or "between waves"
        i = innermost(inside & ~outer)
        return o if i is None else f"{o}: {i[:80]}"
