"""``solve_mfu.long``: the whole solve's share of the float64 peak, in
the long cell (it moves ``trajectory_ms``); see :mod:`metrics._mfu`."""
from portbench.harness import load_file, ROOT

read = load_file(ROOT / "metrics" / "_mfu.py").read
