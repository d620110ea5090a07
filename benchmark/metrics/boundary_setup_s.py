"""Seconds of ``Smoother.enable_boundary_smoothing`` on the benchmark's
clock: the boundary classification and the layer maps' tables."""


def read(ctx):
    return ctx.times.get("boundary_setup_s")
