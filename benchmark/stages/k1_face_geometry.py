"""Face centres, area vectors and vertex means (OpenFOAM's fan
decomposition about the vertex mean), one pass over the faces."""

from harness.work import F32, index_bytes

KERNEL = "face_geometry_kernel"


def work(s):
    reads = F32 * 3 * s["N"] + s["M"] * index_bytes(s["N"]) + s["F"]
    writes = 3 * F32 * 3 * s["F"]
    # a corner: its sub-triangle's centre, normal, area and sums (40);
    # a face: the vertex mean and the two quotients (10)
    return reads + writes, 40 * s["M"] + 10 * s["F"]
