"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (the port's import and its card, the cell's records drawn from the
seed, the scan kernel's library, two warm waves of each of the cell's
bucket shapes), then ``--seconds`` of closed-loop traffic through
``repro_torch.serving.TrajectoryEngine``, then the sampled trajectories
against the plain reference.  The last line of standard output is the
result (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number
compared beside its limit); the last lines of standard error repeat the
numbers compared.  Without a CUDA card, or with fewer cards than the cell
asks for, it prints no result and exits with 2; if the process holds JAX
or the JAX package after the window, with 3.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "src")]


def power_limit():
    """The card's power limit in W, as ``nvidia-smi`` reads it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    bench = harness.benchmark()
    chips = int(harness.find(bench["workloads"], args.workload)["chips"])
    import torch

    # one host thread for torch's CPU operations (the engine pads and
    # stacks each wave on the host): faster and steadier on the card's
    # host than its default of one thread per core (PERF.md, PR 28)
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), t_start=T_START, bench=bench)
    result["device"]["power_limit_w"] = power_limit()
    bad = harness.banned_modules()
    if bad:
        print(f"portbench: the process holds {bad} after the window",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
