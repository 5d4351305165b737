"""``elements.device_ms``: per solve, the device time launched inside the
port's ``solve.elements`` and ``solve.fill`` ranges (the block elements
of the scan and the values inside each block), in ms; see
:mod:`metrics._device_in`."""
from portbench.harness import load_file, ROOT

read = load_file(ROOT / "metrics" / "_device_in.py").reader(
    "solve.elements", "solve.fill")
