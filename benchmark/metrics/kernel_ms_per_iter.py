"""Device time of the program's own kernels (the ``__global__``
functions of its CUDA sources, found by name) an iteration, over the
traced iterations."""


def read(ctx):
    ms = ctx.kernel_s() * 1e3
    return ms / ctx.traced_iters if ctx.traced_iters and ms > 0 else None
