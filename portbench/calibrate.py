"""Readings that the limits of ``correct`` are set from: a cell's sound runs
on many seeds and its control runs, in one process, each a short window at
the cell's own load.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 7,8,9 --seconds 3 [--device cuda]

The control is the program's own float32 path: the same cell with the
configuration's float64 replaced by float32, against the float64
reference.  Prints one JSON line per run (``cell``, ``seed``, ``dtype``,
``x_gap``, ``correct``, ``records``) and, last, the largest sound reading
and the smallest control reading.  The benchmark's own runs never run
this.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "src")]


def reading(result: dict) -> float:
    value = result["checks"]["x_gap"]["value"]
    return math.inf if value is None else value


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from portbench import harness

    runs = [(int(s), None) for s in args.seeds.split(",")]
    runs += [(int(s), "float32") for s in args.control_seeds.split(",") if s]
    sound, control = [], []
    for seed, dtype in runs:
        try:
            result = harness.run_cell(args.workload, seed, args.seconds,
                                      False, device=args.device, dtype=dtype)
            gap, ok = reading(result), result["correct"]
            records = result["metrics"].get("records_per_s", {}).get("value")
        except Exception as exc:           # a control that crashes has failed
            if dtype is None:
                raise
            print(f"control seed {seed} raised {exc!r}", file=sys.stderr)
            gap, ok, records = math.inf, False, None
        (control if dtype else sound).append(gap)
        print(json.dumps({"cell": args.workload, "seed": seed,
                          "dtype": dtype or "config", "x_gap": gap,
                          "correct": ok, "records_per_s": records}),
              flush=True)
    print(json.dumps({"cell": args.workload, "sound_max": max(sound),
                      "control_min": min(control) if control else None}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
