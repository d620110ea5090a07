"""Seconds of ``Smoother(mesh, params)`` on the benchmark's clock: the
reorder, the topology compile, the upload."""


def read(ctx):
    return ctx.times.get("smoother_init_s")
