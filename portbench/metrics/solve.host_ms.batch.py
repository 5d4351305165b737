"""``solve.host_ms.batch``: the host's dispatch of one solve, in the
batch cells (it moves ``records_per_s``); see
:mod:`metrics._solve_host`."""
from portbench.harness import load_file, ROOT

read = load_file(ROOT / "metrics" / "_solve_host.py").read
