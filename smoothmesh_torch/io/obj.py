"""Wavefront OBJ readers for target surfaces and feature-edge meshes.

Replaces the reference's ``triSurface``/``edgeMesh`` OBJ readers
(reference src/smoothMesh.C:2134-2160).  ``f`` polygons are fan
triangulated (matching OpenFOAM's triSurface OBJ import), ``l`` records
become edges (consecutive vertex pairs for polylines).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _parse(path: str):
    verts = []
    tris = []
    edges = []
    with open(path, "r") as f:
        for line in f:
            if not line or line[0] in "#on":
                continue
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                verts.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif tag == "f":
                # OBJ indices are 1-based and may carry /vt/vn suffixes
                idx = [int(p.split("/")[0]) - 1 for p in parts[1:]]
                for i in range(1, len(idx) - 1):
                    tris.append((idx[0], idx[i], idx[i + 1]))
            elif tag == "l":
                idx = [int(p.split("/")[0]) - 1 for p in parts[1:]]
                for i in range(len(idx) - 1):
                    edges.append((idx[i], idx[i + 1]))
    v = np.array(verts, dtype=np.float64).reshape(-1, 3)
    t = np.array(tris, dtype=np.int64).reshape(-1, 3)
    e = np.array(edges, dtype=np.int64).reshape(-1, 2)
    return v, t, e


def read_obj_surface(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Return (vertices (V,3), triangles (T,3)) from an OBJ surface."""
    v, t, _ = _parse(path)
    return v, t


def read_obj_edges(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Return (vertices (V,3), edges (E,2)) from an OBJ edge mesh.

    Mirrors OpenFOAM ``edgeMesh`` semantics: both ``l`` records and the
    boundary edges implied by ``f`` records could define edges, but the
    reference fixtures use pure ``l`` meshes, which is what we support.
    """
    v, t, e = _parse(path)
    if len(e) == 0 and len(t) > 0:
        # Fall back to triangle edges (unique undirected pairs)
        pairs = np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]])
        pairs = np.sort(pairs, axis=1)
        e = np.unique(pairs, axis=0)
    return v, e
