"""``solve.waits.long``: the host's waits for the card in one solve,
in the long cell (it moves ``trajectory_ms``); see
:mod:`metrics._solve_waits`."""
from portbench.harness import load_file, ROOT

read = load_file(ROOT / "metrics" / "_solve_waits.py").read
