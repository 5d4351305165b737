"""``device_idle.long``: the card's idle share of the profiled stretch, in
the long cell (it moves ``trajectory_ms``); see :mod:`metrics._idle`."""
from portbench.harness import load_file, ROOT

read = load_file(ROOT / "metrics" / "_idle.py").read
