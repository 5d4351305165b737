"""``device_idle.open``: the card's idle share of the profiled stretch, in
%, in the open-loop cell (it moves ``record_p95_ms``); see
:mod:`metrics._idle`."""
from portbench.harness import load_file, ROOT

read = load_file(ROOT / "metrics" / "_idle.py").read
