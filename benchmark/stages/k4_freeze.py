"""The edge-shortening and edge-angle freezes, one pass over the
points: each edge neighbour's current and new length, each wedge (a
point's corner of a face) at five positions."""

from harness.work import F32, index_bytes

KERNEL = "freeze_kernel"


def work(s):
    reads = (2 * F32 * 3 * s["N"] + s["PP"] * index_bytes(s["N"]) + s["N"]
             + 2 * s["M"] * index_bytes(s["N"]) + s["N"])
    writes = s["N"]                               # one byte a point
    # an edge neighbour: two lengths (18); a wedge: five angles (125)
    return reads + writes, 18 * s["PP"] + 125 * s["M"]
