"""Per solve, the device time of the operations launched inside the port's
ranges of given names in the profiled stretch, in ms, over its
``estimator.solve`` ranges; see :mod:`portbench.spans`."""
from portbench import spans


def reader(*names):
    def read(ctx):
        return spans.per_solve_ms(ctx, lambda s: s.device_seconds_in(names))
    return read
