"""``lqt_scan_roofline.wide``: the wide scan kernel's share of its
roofline, in l96-batch64 (it moves ``records_per_s``): the bound of
:func:`metrics._roofline.scan_bound_s` (one scan of ``blocks + 1``
elements of ``rows`` records a pass, bytes at the HBM rate or combines at
the float64 peak) over the summed device time of the kernels named
``lqt_scan_wide_kernel`` in the trace (one launch per tree level).  A
program without the kernel reads nothing."""
from portbench.harness import load_file, ROOT

KERNEL = "lqt_scan_wide_kernel"
_roofline = load_file(ROOT / "metrics" / "_roofline.py")


def read(ctx):
    if ctx.profile is None or not ctx.solves:
        return None
    t = ctx.profile.device_seconds(KERNEL)
    if t <= 0:
        return None
    return 100.0 * _roofline.scan_bound_s(ctx) / t
