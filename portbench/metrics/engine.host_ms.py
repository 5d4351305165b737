"""``engine.host_ms``: per wave, the host time of the port's
``engine.step`` span that none of its child spans covers (padding and
stacking the wave, slicing the solutions, bookkeeping), in ms, averaged
over the traced window's waves.  With telemetry on, the estimator's child
span waits for the card, so this is host work alone."""


def self_seconds(tree: dict) -> float:
    return tree["dur_s"] - sum(c["dur_s"] for c in tree.get("children", []))


def read(ctx):
    if not ctx.spans:
        return None
    return sum(self_seconds(t) for t in ctx.spans) / len(ctx.spans) * 1e3
