"""Debug visualization helpers (numpy; the JAX package's
``smoothmesh_tpu.utils.debug``, the same files).

Equivalent of the reference's disabled prismatic-edge STL exporter
(propagateOuterNeighInfo's exportEdgesAsStl,
src/orthogonalBoundaryBlending.C:261-267, 337-355): writes point->
neighbour edges as degenerate STL triangles, best viewed as wireframe
in ParaView.
"""

from __future__ import annotations

import numpy as np

ABS_TOL = 1e-6


def export_edges_as_stl(path: str, points: np.ndarray,
                        point_map: np.ndarray) -> int:
    """Write the edges (i -> point_map[i]) for mapped points as an
    ASCII STL of degenerate triangles.  Returns the edge count."""
    n = 0
    with open(path, "w") as f:
        f.write("solid edgesAsStl\n")
        for i, j in enumerate(np.asarray(point_map)):
            if j < 0:
                continue
            a = points[i]
            b = points[j]
            c = a * (1.0 + ABS_TOL)
            f.write("facet normal 0 0 0\n outer loop\n")
            for v in (a, b, c):
                f.write(f"  vertex {v[0]} {v[1]} {v[2]}\n")
            f.write(" endloop\nendfacet\n")
            n += 1
        f.write("endsolid\n")
    return n
