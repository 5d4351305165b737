"""Per solve, the host time of the port's ``estimator.solve`` ranges in
the profiled stretch less the time the host blocked in waits for the card
inside them: the dispatch of the solve, in ms; see
:mod:`portbench.spans`."""
from portbench import spans


def dispatch_s(s) -> float:
    return s.host_seconds(spans.SOLVE) - s.waits_in(spans.SOLVE)[1]


def read(ctx):
    return spans.per_solve_ms(ctx, dispatch_s)
