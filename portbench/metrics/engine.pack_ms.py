"""``engine.pack_ms``: per wave, the host time of the port's
``engine.pack`` ranges in the profiled stretch (``pack_wave``: each
record padded and the rows stacked on the host, one host-to-device copy
per array), in ms, over the stretch's ``estimator.solve`` ranges (one a
wave); see :mod:`portbench.spans`."""
from portbench import spans


def read(ctx):
    return spans.per_solve_ms(ctx, lambda s: s.host_seconds("engine.pack"))
