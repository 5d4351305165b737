"""``engine.padding_waste``: the port's cumulative ``engine.padding_waste``
gauge at the end of the traced window, in %: the share of the intervals
solved that were padding or recycled rows."""


def read(ctx):
    value = ctx.counters.get("gauges", {}).get("engine.padding_waste")
    return None if value is None else 100.0 * value
