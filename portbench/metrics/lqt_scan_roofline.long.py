"""``lqt_scan_roofline.long``: the scan kernel's share of its roofline, in
the long cell (it moves ``trajectory_ms``); see :mod:`metrics._roofline`."""
from portbench.harness import load_file, ROOT

read = load_file(ROOT / "metrics" / "_roofline.py").read
