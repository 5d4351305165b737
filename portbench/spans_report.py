"""One traced run of a cell, read through the port's ranges: where the
device time and the idle time of the profiled stretch went, by range, and
the host's waits for the card.

    python3 portbench/spans_report.py --workload <cell> --seed <n> \\
        --seconds <s>

Prints one JSON line: the traced run's per-layer ``metrics`` and
``device`` (as ``run.py --trace 1`` gives them), and ``spans``:

* ``device_by_span`` / ``idle_by_span`` -- seconds by the innermost range
  (:mod:`portbench.spans`), with their sums beside the stretch's busy and
  idle seconds;
* ``waits_by_span`` -- ``[count, seconds]`` of the host's waits;
* ``step_share`` -- of the device time launched inside ``engine.step``,
  the share launched inside ``engine.pack``, ``engine.slice`` or a
  ``solve.*`` range, the share inside ``estimator.solve`` but in no
  ``solve.*`` range (``solve, other``: the suffix scan and the
  ``Solution``'s copies), and the innermost ranges of the rest;
* ``paired`` -- the operations paired by launch order, how many of them
  the profiler's own correlation ids pair with the same call, and where
  the launch calls that left no device record lie;
* ``ranges_per_wave`` and ``wave_ms`` (the stretch's waves: median and
  quartiles).
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()

REPO = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "src")]

STEP_PARTS = ("engine.pack", "engine.slice")


def correlated(prof, s) -> dict:
    """The order pairing against the profiler's own correlation ids: how
    many pairs they confirm, and where the stretch's launch calls with no
    device record lie (before the first paired call, between, after)."""
    from torch.autograd import DeviceType

    from portbench import spans

    calls, link = {}, {}
    for e in prof.events():
        row = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CPU:
            if spans.call_kind(e.name):
                calls[e.id] = row
        elif not e.is_user_annotation:
            link[row[:2]] = e.id
    p, ran = s.profile, set(link.values())
    lost = sorted(c[1] for i, c in calls.items()
                  if i not in ran and p.t0 <= c[1] <= p.t1)
    first, last = s.pairs[0][0][1], s.pairs[-1][0][1]
    return {"pairs": len(s.pairs),
            "confirmed": sum(calls.get(link.get(op[:2])) == c
                             for c, op in s.pairs),
            "lost": [sum(t < first for t in lost),
                     sum(first < t < last for t in lost),
                     sum(t > last for t in lost)]}


def step_share(s) -> dict:
    from portbench import spans

    inside, other, rest = 0.0, 0.0, collections.Counter()
    for (_, op), names in zip(s.pairs, s.launched_in):
        if "engine.step" not in names:
            continue
        dur = (op[2] - op[1]) / 1e6
        if any(n in STEP_PARTS or n.startswith("solve.") for n in names):
            inside += dur
        elif spans.SOLVE in names:
            other += dur
        else:
            rest[names[-1]] += dur
    total = inside + other + sum(rest.values())
    return {"share": inside / total if total else None,
            "solve, other": other / total if total else None,
            "rest": dict(rest.most_common())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from portbench import harness, profiling, spans

    torch.set_num_threads(1)             # as run.py
    if not torch.cuda.is_available():
        print("spans_report: needs a CUDA card", file=sys.stderr)
        return 2
    seen = []
    keep = harness.Tracer.profile

    def kept(self):
        seen.append((self.prof, keep(self)))
        return seen[-1][1]

    harness.Tracer.profile = kept
    result = harness.run_cell(args.workload, args.seed, args.seconds, True,
                              t_start=T_START)
    prof, p = seen[0]
    s = spans.Stretch(p)
    waves = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.name == profiling.MARKER
             and e.device_type == torch.autograd.DeviceType.CPU]
    dev, idle = s.device_by_span(), s.idle_by_span()
    out = {
        "workload": args.workload, "seed": args.seed,
        "metrics": result["metrics"], "device": result["device"],
        "correct": result["correct"],
        "spans": {
            "device_by_span": dev,
            "device_sum_s": None if dev is None else sum(dev.values()),
            "busy_s": p.busy_s,
            "idle_by_span": idle,
            "idle_sum_s": sum(idle.values()),
            "idle_s": p.window_s - p.busy_s,
            "waits_by_span": s.waits_by_span(),
            "step_share": None if s.pairs is None else step_share(s),
            "paired": correlated(prof, s) if s.pairs else None,
            "ops": len(p.ops),
            "ranges_per_wave": len(s.ranges) / max(1, len(waves)),
            "wave_ms": np.percentile(waves, [50, 25, 75]).tolist(),
        },
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
