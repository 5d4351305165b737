"""``recover.device_ms``: per solve, the device time launched inside the
port's ``solve.recover`` ranges (the trajectory's recovery, eq. 47), in
ms; see :mod:`metrics._device_in`."""
from portbench.harness import load_file, ROOT

read = load_file(ROOT / "metrics" / "_device_in.py").reader("solve.recover")
