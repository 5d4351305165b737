"""The scan kernel's share of its roofline over the profiled stretch.

Its launches are counted from the stretch's solves: one ``lqt_scan``
launch of ``blocks + 1`` elements of ``rows`` records per pass.  The bound
of each is the larger of its bytes (``counts.scan_bytes``) over the HBM
rate and its combines' operations (``counts.scan_combines`` times
``counts.combine_flops``) over the float64 peak; the share is the bound
summed over the launches, over the summed device time of the kernels named
``lqt_scan_kernel`` in the trace.
"""
from portbench import counts, peaks

KERNEL = "lqt_scan_kernel"


def scan_bound_s(ctx) -> float:
    cfg = ctx.config
    nsub, passes = cfg["options"]["nsub"], cfg.get("iterations") or 1
    nx = len(cfg["m0"])
    total = 0.0
    for rows, n, _ in ctx.solves:
        elems = n // nsub + 1
        nbytes = counts.scan_bytes(elems, rows, nx, ctx.itemsize)
        flops = counts.scan_combines(elems) * rows * counts.combine_flops(nx)
        total += passes * max(nbytes / peaks.HBM_BYTES_PER_S,
                              flops / peaks.FP64_FLOPS)
    return total


def read(ctx):
    if ctx.profile is None or not ctx.solves:
        return None
    t = ctx.profile.device_seconds(KERNEL)
    if t <= 0:
        return None
    return 100.0 * scan_bound_s(ctx) / t
