"""``setup_s``: process start to the start of the measured window (host
clock): imports, the card, the records, the scan kernel's library (its
build in a checkout's first run) and the warm waves."""


def read(ctx):
    return ctx.setup_s
