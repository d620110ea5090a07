"""Face-angle stops (``Smoother.face_angle_stops``: batches that met a
point in the face-angle band and went on one iteration a dispatch) in
the window, per 1000 iterations completed."""


def read(ctx):
    return 1000.0 * ctx.stops / ctx.iterations if ctx.iterations else None
