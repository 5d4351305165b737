"""The parallel smoother's operations for the records completed in the
profiled stretch (``counts.record_flops`` of each record's own length:
the padding of a bucket and the recycled rows of a short wave are not
counted), over the stretch's seconds and the float64 peak, in %."""
from portbench import counts, peaks


def read(ctx):
    p = ctx.profile
    if p is None or p.window_s <= 0 or not ctx.record_lengths:
        return None
    cfg = ctx.config
    nsub, passes = cfg["options"]["nsub"], cfg.get("iterations") or 1
    nx = len(cfg["m0"])
    flops = sum(counts.record_flops(int(n), nsub, nx, ctx.ny, passes,
                                    linearised=cfg["model"] == "nonlinear")
                for n in ctx.record_lengths)
    return 100.0 * flops / (p.window_s * peaks.FP64_FLOPS)
