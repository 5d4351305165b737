"""``solve.waits.batch``: the host's waits for the card in one solve,
in the batch cells (it moves ``records_per_s``); see
:mod:`metrics._solve_waits`."""
from portbench.harness import load_file, ROOT

read = load_file(ROOT / "metrics" / "_solve_waits.py").read
