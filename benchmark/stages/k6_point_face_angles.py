"""Each point's min and max face angle over its edges."""

from harness.work import F32, index_bytes

KERNEL = "point_face_angles_kernel"


def work(s):
    reads = 2 * F32 * s["E"] + 2 * s["E"] * index_bytes(s["E"]) + s["N"]
    writes = 2 * F32 * s["N"]
    return reads + writes, 4 * s["E"]
