"""The median, over every iteration the window completed, of its
``StepResult.wall_ms`` (its batch's host wall over the iterations in
it)."""

import numpy as np


def read(ctx):
    return float(np.median(ctx.walls)) if ctx.walls else None
