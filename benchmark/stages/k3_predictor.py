"""The predictor: centroidal smoothing, the aspect-ratio blend of the
two closest points and the step limiter, one pass over the points."""

from harness.work import F32, index_bytes

KERNEL = "predictor_kernel"


def work(s):
    reads = (F32 * 3 * s["N"] + F32 * 3 * s["C"]
             + s["PC"] * index_bytes(s["C"]) + s["N"]
             + s["PP"] * index_bytes(s["N"]) + s["N"]
             + s["N"])                            # the internal flags
    writes = F32 * 3 * s["N"]
    # a point-cell: the centroid's sum (3); an edge neighbour: its
    # vector and length (9); a point: ratios, blend and limiter (40)
    return reads + writes, 3 * s["PC"] + 9 * s["PP"] + 40 * s["N"]
