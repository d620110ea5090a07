"""Points times the iterations the window completed, over the window's
wall seconds (host clock, from the first job's start to the
synchronize after the last)."""


def read(ctx):
    return ctx.n_points * ctx.iterations / ctx.window_s
