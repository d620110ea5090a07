"""Device time of every other device operation (PyTorch's kernels,
copies and fills) an iteration, over the traced iterations."""


def read(ctx):
    if not ctx.trace or not ctx.traced_iters:
        return None
    other = sum(ctx.trace["by_op"].values()) - ctx.kernel_s()
    return other * 1e3 / ctx.traced_iters
