"""Snapshot + benchmark-artifact export (the ``BENCH_<name>.json`` files).

``snapshot()`` is the one-call readout of everything recorded: counters,
gauges, histogram summaries (p50/p90/p99) and, optionally, the recent
span trees.

``bench_record``/``write_bench_json`` produce the schema-versioned
benchmark artifact of the reference (schema v1, unchanged; documented in
``docs/OBSERVABILITY.md``), so ``benchmarks/compare.py`` can gate the
port's numbers as it gates the reference's.  Every record carries the RNG
seeds used and an environment fingerprint (torch and CUDA versions, the
card's name, count and power limit, the default dtype,
``CUDA_VISIBLE_DEVICES``) so a number is never detached from the machine
state that produced it.
"""
from __future__ import annotations

import functools
import json
import os
import platform
import subprocess
from typing import Dict, List, Optional, Sequence

from . import metrics, tracing

SCHEMA_VERSION = 1

# every benchmark row must carry exactly these (run.py's CSV columns)
ROW_KEYS = ("name", "us_per_call", "derived")


def snapshot(include_trees: bool = False) -> dict:
    """Everything recorded so far: ``{"enabled", "counters", "gauges",
    "histograms", "dropped_records"[, "span_trees"]}``."""
    out = {"enabled": metrics.enabled()}
    out.update(metrics.REGISTRY.snapshot())
    if include_trees:
        out["span_trees"] = tracing.span_trees()
    return out


@functools.lru_cache(maxsize=1)
def _power_limit() -> Optional[str]:
    """The first card's ``name, power.limit`` as ``nvidia-smi`` prints
    them (read once per process); ``None`` where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def env_fingerprint() -> dict:
    """Machine/runtime state a benchmark number depends on: Python, the
    platform, torch and its CUDA, the card (name, count, and the power
    limit where a card is present), the default dtype and
    ``CUDA_VISIBLE_DEVICES``."""
    import torch

    cuda = torch.cuda.is_available()
    return {
        "python": platform.python_version(),
        "platform": platform.platform(),
        "cpu_count": os.cpu_count(),
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 0,
        "power_limit": _power_limit() if cuda else None,
        "default_dtype": str(torch.get_default_dtype()),
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES", ""),
    }


def bench_record(name: str, rows: Sequence[Dict],
                 seeds: Optional[Dict[str, int]] = None,
                 obs_snapshot: Optional[dict] = None) -> dict:
    """Assemble a schema-v1 benchmark artifact from harness rows."""
    rows = [
        {"name": str(r["name"]),
         "us_per_call": float(r["us_per_call"]),
         "derived": str(r["derived"])}
        for r in rows
    ]
    return {
        "schema_version": SCHEMA_VERSION,
        "benchmark": name,
        "seeds": dict(seeds or {}),
        "env": env_fingerprint(),
        "rows": rows,
        "obs": snapshot() if obs_snapshot is None else obs_snapshot,
    }


def validate_bench(record: dict) -> List[str]:
    """Schema-check a benchmark record; returns a list of problems
    (empty == valid).  Kept in sync with ``docs/OBSERVABILITY.md``."""
    problems: List[str] = []
    if not isinstance(record, dict):
        return ["record is not a JSON object"]
    if record.get("schema_version") != SCHEMA_VERSION:
        problems.append(
            f"schema_version must be {SCHEMA_VERSION}, "
            f"got {record.get('schema_version')!r}")
    for key, typ in (("benchmark", str), ("seeds", dict), ("env", dict),
                     ("rows", list), ("obs", dict)):
        if not isinstance(record.get(key), typ):
            problems.append(f"missing or mistyped field {key!r} "
                            f"(want {typ.__name__})")
    for i, row in enumerate(record.get("rows") or []):
        if not isinstance(row, dict):
            problems.append(f"rows[{i}] is not an object")
            continue
        for k in ROW_KEYS:
            if k not in row:
                problems.append(f"rows[{i}] missing {k!r}")
        if not isinstance(row.get("us_per_call", 0.0), (int, float)):
            problems.append(f"rows[{i}].us_per_call is not a number")
    obs = record.get("obs")
    if isinstance(obs, dict):
        for key in ("counters", "gauges", "histograms"):
            if not isinstance(obs.get(key), dict):
                problems.append(f"obs.{key} missing or mistyped")
    return problems


def write_bench_json(path: str, record: dict) -> str:
    """Validate and write a benchmark artifact; returns ``path``."""
    problems = validate_bench(record)
    if problems:
        raise ValueError("invalid benchmark record: " + "; ".join(problems))
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
        f.write("\n")
    return path
