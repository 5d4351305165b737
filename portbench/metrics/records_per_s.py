"""``records_per_s``: records whose trajectory reached the host inside the
window, over the window's seconds (host clock)."""


def read(ctx):
    return ctx.completed / ctx.window_s
