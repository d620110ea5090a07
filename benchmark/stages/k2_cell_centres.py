"""Cell centres (OpenFOAM's face-pyramid decomposition about the mean
of the face centres), one pass over the cells."""

from harness.work import F32, index_bytes

KERNEL = "cell_centres_kernel"


def work(s):
    reads = (2 * F32 * 3 * s["F"] + s["CF"] * index_bytes(s["F"]) + s["C"]
             + s["F"] * index_bytes(s["C"]))     # the owner gives the sign
    writes = F32 * 3 * s["C"]
    # a cell face: the estimate's sum, the pyramid volume and the
    # weighted centre (28); a cell: the quotients (10)
    return reads + writes, 28 * s["CF"] + 10 * s["C"]
