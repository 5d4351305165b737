"""``scan.device_ms``: per solve, the device time launched inside the
port's ``solve.scan`` ranges (the eq.-(42) suffix scan of each pass), in
ms; see :mod:`metrics._device_in`.  A program without the range reads
nothing."""
from portbench.harness import load_file, ROOT

read = load_file(ROOT / "metrics" / "_device_in.py").reader("solve.scan")
