"""``record_p95_ms``: the 95th percentile, over every record completed in
the window, of the time from ``submit`` to its trajectory on the host
(host clock; raw per-record times, linear interpolation)."""
import numpy as np


def read(ctx):
    if ctx.latencies_s.size == 0:
        return None
    return float(np.percentile(ctx.latencies_s, 95)) * 1e3
