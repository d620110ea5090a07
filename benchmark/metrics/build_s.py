"""Seconds to build the port's compiled parts where the checkout has
none (its first run: ``nvcc`` for the CUDA kernels, the C++ compiler for
the topology compiler) and to load them; on a built checkout, the
load alone."""


def read(ctx):
    return ctx.times.get("build_s")
