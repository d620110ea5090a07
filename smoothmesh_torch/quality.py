"""Mesh statistics used for the derived parameter defaults.

The reference's mesh stats (min/max edge length + bounding-box
perimeter, src/smoothMesh.C:1478-1541), computed on the host with
numpy.  The checkMesh-style quality report arrives in a later slice of
the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class MeshStats:
    min_edge_length: float
    max_edge_length: float
    perimeter: float   # sum of bounding-box side lengths (reference quirk:
                       # z-term is max+min, matching src/smoothMesh.C:1538)


def mesh_stats(points: np.ndarray, edges: np.ndarray) -> MeshStats:
    p = np.asarray(points)
    e = np.asarray(edges)
    lengths = np.linalg.norm(p[e[:, 1]] - p[e[:, 0]], axis=1)
    mins = p.min(axis=0)
    maxs = p.max(axis=0)
    perimeter = (maxs[0] - mins[0]) + (maxs[1] - mins[1]) + (maxs[2] + mins[2])
    return MeshStats(float(lengths.min()), float(lengths.max()),
                     float(perimeter))
