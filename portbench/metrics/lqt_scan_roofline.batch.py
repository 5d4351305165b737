"""``lqt_scan_roofline.batch``: the scan kernel's share of its roofline, in
the batch cells (it moves ``records_per_s``); see :mod:`metrics._roofline`."""
from portbench.harness import load_file, ROOT

read = load_file(ROOT / "metrics" / "_roofline.py").read
