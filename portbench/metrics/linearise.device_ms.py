"""``linearise.device_ms``: per solve, the device time launched inside the
port's ``solve.linearise`` ranges (Taylor linearisation of every point,
each pass), in ms; see :mod:`metrics._device_in`."""
from portbench.harness import load_file, ROOT

read = load_file(ROOT / "metrics" / "_device_in.py").reader("solve.linearise")
