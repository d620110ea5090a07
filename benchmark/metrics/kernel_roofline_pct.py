"""The least time of the iteration's work stages (``benchmark/stages``:
the larger of bytes over the HBM bandwidth and float32 operations over
the float32 peak, summed over the stages the cell runs) over the
device time of the program's kernels, an iteration."""

from harness import work


def read(ctx):
    kernel_s = ctx.kernel_s()
    if not ctx.traced_iters or kernel_s <= 0:
        return None
    least = sum(work.least_seconds(b, o) for b, o in ctx.stage_work.values())
    return 100.0 * least * ctx.traced_iters / kernel_s
