"""``solve.host_ms.long``: the host's dispatch of one solve, in the long
cell (it moves ``trajectory_ms``); see :mod:`metrics._solve_host`."""
from portbench.harness import load_file, ROOT

read = load_file(ROOT / "metrics" / "_solve_host.py").read
