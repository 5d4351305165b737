"""``device_idle.batch``: the card's idle share of the profiled stretch, in
the batch cells (it moves ``records_per_s``); see :mod:`metrics._idle`."""
from portbench.harness import load_file, ROOT

read = load_file(ROOT / "metrics" / "_idle.py").read
