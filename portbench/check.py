"""How ``correct`` is decided: the sampled trajectories against the plain
reference, recomputed from the same measurements.

The number compared is ``x_gap``: over the sampled records, the largest
``max_k |x_port(t_k) - x_ref(t_k)| / max_k |x_ref(t_k)|`` (every state
component, every point of the record's own grid).  A trajectory that is
not finite reads ``inf``.  Its limit sits in the cell's file
(``workloads/<cell>.json``), set from the readings that ``PERF.md`` gives.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np


def x_gap(cfg: dict, reference, pool, kept: List[Tuple[int, np.ndarray]]
          ) -> float:
    """The widest relative gap of the kept ``(pool index, x)`` pairs."""
    if not kept:
        return math.inf
    idx = np.array([i for i, _ in kept])
    lengths = pool.lengths[idx]
    steps = int(lengths.max())
    want = reference.solve(cfg, pool.y[idx, :steps], lengths)
    gap = 0.0
    for (_, x), n, ref in zip(kept, lengths, want):
        ref = ref[:n + 1]
        if x.shape != ref.shape or not np.all(np.isfinite(x)):
            return math.inf
        gap = max(gap, float(np.max(np.abs(x - ref)) / np.max(np.abs(ref))))
    return gap
