"""``trajectory_ms``: the window's seconds over the trajectories completed
in it (host clock): the time to one long trajectory."""


def read(ctx):
    if ctx.completed == 0:
        return None
    return ctx.window_s / ctx.completed * 1e3
