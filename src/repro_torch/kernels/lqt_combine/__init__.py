from . import scan
from .kernel import build, launch_count, lqt_combine_lanes, reset_launch_count
from .ops import (
    kernel_prefix_scan,
    kernel_suffix_scan,
    lqt_combine_batched,
    scan_combine_fn,
)
from .ref import lqt_combine_lanes_ref, lqt_combine_ref, lqt_scan_ref
from .scan import lqt_scan, lqt_scan_wide

__all__ = [
    "build",
    "kernel_prefix_scan",
    "kernel_suffix_scan",
    "launch_count",
    "lqt_combine_batched",
    "lqt_combine_lanes",
    "lqt_combine_lanes_ref",
    "lqt_combine_ref",
    "lqt_scan",
    "lqt_scan_ref",
    "lqt_scan_wide",
    "reset_launch_count",
    "scan",
    "scan_combine_fn",
]
