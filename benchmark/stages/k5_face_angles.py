"""The current face-face angles of each edge (the min and max over its
cells of the two faces' angle about the cell centre, in the plane
normal to the edge), one pass over the edges."""

from harness.work import F32, index_bytes

KERNEL = "face_angles_kernel"


def work(s):
    reads = (F32 * 3 * (s["N"] + s["F"] + s["C"])
             + 2 * s["E"] * index_bytes(s["N"])
             + s["M"] * index_bytes(s["F"]) + s["E"]   # the edges' faces
             + s["EC"] * index_bytes(s["C"]) + s["E"]  # the edges' cells
             + 2 * s["EC"])             # each cell's two faces, as slots
    writes = 2 * F32 * s["E"]
    # an edge: midpoint and direction (15); an edge face: its
    # projection (20); an edge cell: its projection and the angle (45)
    return reads + writes, 15 * s["E"] + 20 * s["M"] + 45 * s["EC"]
