"""``cost.device_ms``: per solve, the device time launched inside the
port's ``solve.cost`` ranges (the Onsager-Machlup cost of the estimate,
and in an iterated solve each pass's cost and step norm), in ms; see
:mod:`metrics._device_in`."""
from portbench.harness import load_file, ROOT

read = load_file(ROOT / "metrics" / "_device_in.py").reader("solve.cost")
