"""Spatial mesh reordering.

Points are ordered by balanced recursive coordinate bisection (RCB);
cells and faces then follow their minimum new point id, and the edges
the topology compiler derives (sorted by (min point, max point)) inherit
the same order.  Neighbouring entities thus sit close in memory, so the
kernels' per-row gathers of point, face and cell data mostly hit cache
lines and L2 sectors that their neighbouring threads load too.

The reference has no analog — OpenFOAM meshes arrive in generator
order.  The reordering is semantics-preserving: face windings,
owner/neighbour roles and patch ranges are untouched, and
:class:`MeshOrders` maps fields back to the original order.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from smoothmesh_torch.io.polymesh import PolyMesh

LEAF = 1024           # points per RCB leaf


def rcb_order(coords: np.ndarray, leaf: int = LEAF) -> np.ndarray:
    """Balanced RCB ordering: returns ``order`` s.t. coords[order] is
    arranged leaf-by-leaf; every leaf has (almost) equal count <= leaf.

    Iterative median splits along the widest axis of each part.
    """
    n = len(coords)
    order = np.arange(n)
    if n <= leaf:
        return order
    parts = [order]
    while max(len(p) for p in parts) > leaf:
        nxt = []
        for p in parts:
            if len(p) <= leaf:
                nxt.append(p)
                continue
            c = coords[p]
            ax = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
            half = len(p) // 2
            sel = np.argpartition(c[:, ax], half)
            nxt.append(p[sel[:half]])
            nxt.append(p[sel[half:]])
        parts = nxt
    return np.concatenate(parts)


@dataclasses.dataclass
class MeshOrders:
    """new-id = perm_*[old-id] maps for a permuted mesh."""

    point_new: np.ndarray    # (N,) old -> new
    point_old: np.ndarray    # (N,) new -> old
    cell_new: np.ndarray
    cell_old: np.ndarray
    face_new: np.ndarray
    face_old: np.ndarray


def _group_order_by_key(key: np.ndarray) -> np.ndarray:
    """Stable order of ids by key (new-id -> old-id)."""
    return np.argsort(key, kind="stable")


def permute_mesh(mesh: PolyMesh) -> Tuple[PolyMesh, MeshOrders]:
    """Spatially reorder a PolyMesh.

    Points: RCB on coordinates.  Cells: by min new point id.  Faces:
    by min new point id, permuted only within the internal-face range
    and within each patch range (patch start/count preserved).  Face
    windings, owner/neighbour roles and patch metadata are untouched,
    so geometry semantics (normals owner->neighbour) are preserved.
    """
    N, F, Fi = mesh.n_points, mesh.n_faces, mesh.n_internal_faces
    C = mesh.n_cells

    p_old = rcb_order(np.asarray(mesh.points, np.float64))
    p_new = np.empty(N, dtype=np.int64)
    p_new[p_old] = np.arange(N)

    offs = mesh.face_offsets.astype(np.int64)
    counts = np.diff(offs)
    flat_new = p_new[mesh.face_flat]

    # min new point per face / per cell
    face_min = np.minimum.reduceat(flat_new, offs[:-1])
    cell_min = np.full(C, np.iinfo(np.int64).max)
    np.minimum.at(cell_min, mesh.owner, face_min)
    np.minimum.at(cell_min, mesh.neighbour, face_min[: Fi])

    c_old = _group_order_by_key(cell_min)
    c_new = np.empty(C, dtype=np.int64)
    c_new[c_old] = np.arange(C)

    f_old = np.arange(F)
    f_old[:Fi] = _group_order_by_key(face_min[:Fi])
    for p in mesh.patches:
        s, e = p.start_face, p.start_face + p.n_faces
        f_old[s:e] = s + _group_order_by_key(face_min[s:e])

    # rebuild ragged faces in the new face order with new point ids:
    # entry k of new face g reads old entry offs[f_old[g]] + k
    new_counts = counts[f_old]
    new_offs = np.zeros(F + 1, dtype=np.int64)
    np.cumsum(new_counts, out=new_offs[1:])
    gather_idx = (np.arange(new_offs[-1], dtype=np.int64)
                  + np.repeat(offs[f_old] - new_offs[:-1], new_counts))
    new_flat = flat_new[gather_idx]

    new_mesh = PolyMesh(
        points=np.ascontiguousarray(mesh.points[p_old]),
        face_flat=new_flat,
        face_offsets=new_offs,
        owner=c_new[mesh.owner[f_old]],
        neighbour=c_new[mesh.neighbour[f_old[:Fi]]],
        patches=list(mesh.patches),
    )
    orders = MeshOrders(
        point_new=p_new, point_old=p_old,
        cell_new=c_new, cell_old=c_old,
        face_new=np.argsort(f_old), face_old=f_old,
    )
    return new_mesh, orders
