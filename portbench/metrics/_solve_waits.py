"""Per solve, the host's waits for the card inside the port's
``estimator.solve`` ranges in the profiled stretch (a stream, device or
event synchronise, or a copy call whose device copy is ``Memcpy DtoH``);
see :mod:`portbench.spans`."""
from portbench import spans


def read(ctx):
    s = spans.stretch(ctx)
    if s is None:
        return None
    return s.waits_in(spans.SOLVE)[0] / s.solves()
