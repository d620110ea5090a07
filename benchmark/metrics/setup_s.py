"""Seconds from the process start to the window's start: imports,
kernel load or build, mesh generation, the smoother's set-up, the
boundary set-up, the capture and the warm batch."""


def read(ctx):
    return ctx.setup_s
