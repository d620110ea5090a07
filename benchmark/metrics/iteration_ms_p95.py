"""The 95th percentile, over every iteration the window completed, of
its ``StepResult.wall_ms`` (the program's own clock around its batch,
dispatch to host read, over the iterations in it)."""

import numpy as np


def read(ctx):
    return float(np.percentile(ctx.walls, 95)) if ctx.walls else None
