"""``solve_mfu.batch``: the whole solve's share of the float64 peak, in
the batch cells (it moves ``records_per_s``); see :mod:`metrics._mfu`."""
from portbench.harness import load_file, ROOT

read = load_file(ROOT / "metrics" / "_mfu.py").read
