"""Mesh construction tools mirroring the reference testcase pipelines.

- :func:`extrude_triangulation` — the ``extrude2DMesh`` +  ``topoSet``
  + ``createPatch`` pipeline of reference testcase1
  (testcase/run_serial:12-14, system/extrude2DMeshDict,
  system/topoSetDict, system/createPatchDict): a 2D triangulated
  surface extruded along a direction into triangular-prism cells, with
  boundary faces sorted into box-selected patches and a default patch.
- :func:`create_baffles` — the ``createBaffles`` + ``splitBaffles``
  pipeline of reference testcase6 (testcase6/run_serial:14-16,
  system/createBafflesDict): selected internal faces are duplicated
  into two zero-thickness boundary faces (owner/neighbour side), and
  interior baffle points are topologically split so the two sides move
  independently (OpenFOAM mergeOrSplitBaffles -split).

Host-side fixture tooling, not on the device hot path.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from smoothmesh_torch.io.polymesh import Patch, PolyMesh


def extrude_triangulation(
    verts: np.ndarray,
    tris: np.ndarray,
    direction: Sequence[float] = (0.0, 1.0, 0.0),
    thickness: float = 1.5,
    n_layers: int = 15,
    patch_boxes: Sequence[Tuple[str, Sequence[float], Sequence[float]]] = (),
    default_name: str = "defaultFaces",
) -> PolyMesh:
    """Extrude a triangulated surface into n_layers of prism cells.

    ``verts``: (V, 3) surface points (the k=0 layer); ``tris``:
    (T, 3) triangle point ids (any orientation — normalized so all
    normals align with ``direction``).  Boundary faces whose centre
    falls inside a ``patch_boxes`` box (first match wins, mirroring
    topoSet boxToFace + createPatch) go to that patch; the rest go to
    ``default_name`` (extrude2DMeshDict patchType patch).
    """
    verts = np.asarray(verts, np.float64)
    tris = np.asarray(tris, np.int64).copy()
    d = np.asarray(direction, np.float64)
    d = d / np.linalg.norm(d)
    V, T = len(verts), len(tris)
    K = int(n_layers)

    # orient all triangles CCW as seen from +direction
    n_t = np.cross(verts[tris[:, 1]] - verts[tris[:, 0]],
                   verts[tris[:, 2]] - verts[tris[:, 0]])
    flip = n_t @ d < 0
    tris[flip] = tris[flip][:, [0, 2, 1]]

    # points: layer k at verts + k*h*d
    h = thickness / K
    pts = (verts[None, :, :] + (np.arange(K + 1) * h)[:, None, None]
           * d[None, None, :]).reshape(-1, 3)

    def pid(k, v):
        return k * V + v

    # edge table: directed edges per tri; pair opposite directions
    de = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]],
                         tris[:, [2, 0]]])                 # (3T, 2)
    de_tri = np.tile(np.arange(T), 3)
    key = de[:, 0] * V + de[:, 1]
    rkey = de[:, 1] * V + de[:, 0]
    order = np.argsort(key, kind="stable")
    rpos = np.searchsorted(key[order], rkey)
    has_twin = (rpos < len(key)) & (
        key[order][np.minimum(rpos, len(key) - 1)] == rkey)
    twin_tri = np.where(has_twin, de_tri[order][np.minimum(
        rpos, len(key) - 1)], -1)
    # interior edge: has twin; keep ONE of the two directed copies
    # (the one whose tri id is smaller -> deterministic owner)
    interior = has_twin & (de_tri < twin_tri)
    boundary_e = ~has_twin

    faces: List[np.ndarray] = []
    owner: List[int] = []
    neighbour: List[int] = []

    def cell(k, t):
        return k * T + t

    # internal vertical quads (interior edges, all layers)
    for e in np.where(interior)[0]:
        a, b = de[e]
        t1, t2 = de_tri[e], twin_tri[e]
        for k in range(K):
            faces.append(np.array([pid(k, a), pid(k, b),
                                   pid(k + 1, b), pid(k + 1, a)]))
            owner.append(cell(k, t1))
            neighbour.append(cell(k, t2))
    # internal horizontal triangles between layers
    for t in range(T):
        v0, v1, v2 = tris[t]
        for k in range(K - 1):
            faces.append(np.array([pid(k + 1, v0), pid(k + 1, v1),
                                   pid(k + 1, v2)]))
            owner.append(cell(k, t))
            neighbour.append(cell(k + 1, t))

    n_internal = len(faces)

    # boundary faces: front (k=0, outward -d), back (k=K, outward +d),
    # side quads on boundary edges
    bfaces: List[np.ndarray] = []
    bowner: List[int] = []
    for t in range(T):
        v0, v1, v2 = tris[t]
        bfaces.append(np.array([pid(0, v0), pid(0, v2), pid(0, v1)]))
        bowner.append(cell(0, t))
        bfaces.append(np.array([pid(K, v0), pid(K, v1), pid(K, v2)]))
        bowner.append(cell(K - 1, t))
    for e in np.where(boundary_e)[0]:
        a, b = de[e]
        t1 = de_tri[e]
        for k in range(K):
            bfaces.append(np.array([pid(k, a), pid(k, b),
                                    pid(k + 1, b), pid(k + 1, a)]))
            bowner.append(cell(k, t1))

    # classify boundary faces into box patches (face centre test)
    centres = np.stack([pts[f].mean(axis=0) for f in bfaces])
    assign = np.full(len(bfaces), len(patch_boxes), dtype=np.int64)
    for i, (_, lo, hi) in enumerate(patch_boxes):
        lo = np.asarray(lo)
        hi = np.asarray(hi)
        inside = np.all((centres >= lo) & (centres <= hi), axis=1)
        assign = np.where((assign == len(patch_boxes)) & inside, i,
                          assign)

    patches: List[Patch] = []
    pos = n_internal
    order_b = np.argsort(assign, kind="stable")
    names = [name for name, _, _ in patch_boxes] + [default_name]
    for i, name in enumerate(names):
        cnt = int((assign == i).sum())
        if cnt == 0 and i == len(patch_boxes):
            continue
        patches.append(Patch(name=name, type="patch", n_faces=cnt,
                             start_face=pos))
        pos += cnt

    all_faces = faces + [bfaces[i] for i in order_b]
    all_owner = owner + [bowner[i] for i in order_b]
    flat = np.concatenate(all_faces)
    offsets = np.zeros(len(all_faces) + 1, dtype=np.int64)
    np.cumsum([len(f) for f in all_faces], out=offsets[1:])
    mesh = PolyMesh(points=pts, face_flat=flat, face_offsets=offsets,
                    owner=np.asarray(all_owner, np.int64),
                    neighbour=np.asarray(neighbour, np.int64),
                    patches=patches)
    mesh.validate()
    return mesh


def create_baffles(mesh: PolyMesh, face_ids: np.ndarray,
                   name: str = "baffle", slave_name: str = "baffle_slave",
                   split: bool = True) -> PolyMesh:
    """Turn internal faces into zero-thickness baffle wall pairs.

    Each selected internal face becomes TWO boundary faces: one owned
    by the original owner cell (patch ``name``, normal unchanged) and
    one owned by the original neighbour cell (patch ``slave_name``,
    reversed winding) — reference createBafflesDict
    (testcase6/system/createBafflesDict: internalFacesOnly, owner/
    neighbour wall patches).  With ``split``, interior baffle points
    (not on the baffle rim) are duplicated so the two sides are
    topologically independent (splitBaffles / mergeOrSplitBaffles
    -split in testcase6/run_serial:15-16); rim points stay shared.
    """
    face_ids = np.asarray(sorted(set(int(f) for f in face_ids)))
    Fi = mesh.n_internal_faces
    if len(face_ids) and (face_ids.min() < 0 or face_ids.max() >= Fi):
        raise ValueError("baffle faces must be internal")
    sel = np.zeros(Fi, dtype=bool)
    sel[face_ids] = True

    flat, offs = mesh.face_flat, mesh.face_offsets
    fpts = [flat[offs[f]: offs[f + 1]].copy() for f in range(mesh.n_faces)]

    keep_int = [f for f in range(Fi) if not sel[f]]
    # new face order: kept internal, original patches (unchanged),
    # baffle owner-side, baffle neighbour-side
    new_faces = [fpts[f] for f in keep_int]
    new_owner = [mesh.owner[f] for f in keep_int]
    new_neigh = [mesh.neighbour[f] for f in keep_int]
    for p in mesh.patches:
        for f in range(p.start_face, p.start_face + p.n_faces):
            new_faces.append(fpts[f])
            new_owner.append(mesh.owner[f])
    owner_side = []
    for f in face_ids:
        owner_side.append(len(new_faces))
        new_faces.append(fpts[f])
        new_owner.append(mesh.owner[f])
    slave_side = []
    for f in face_ids:
        slave_side.append(len(new_faces))
        new_faces.append(fpts[f][::-1].copy())
        new_owner.append(mesh.neighbour[f])

    n_internal = len(keep_int)
    patches = []
    pos = n_internal
    for p in mesh.patches:
        patches.append(Patch(name=p.name, type=p.type, n_faces=p.n_faces,
                             start_face=pos))
        pos += p.n_faces
    patches.append(Patch(name=name, type="wall",
                         n_faces=len(face_ids), start_face=pos))
    pos += len(face_ids)
    patches.append(Patch(name=slave_name, type="wall",
                         n_faces=len(face_ids), start_face=pos))

    points = mesh.points.copy()

    if split and len(face_ids):
        # rim = points on baffle edges used by exactly one baffle face;
        # all other baffle points get split
        edge_count: Dict[Tuple[int, int], int] = {}
        for f in face_ids:
            pts = fpts[f]
            for i in range(len(pts)):
                a, b = int(pts[i]), int(pts[(i + 1) % len(pts)])
                k = (a, b) if a < b else (b, a)
                edge_count[k] = edge_count.get(k, 0) + 1
        rim_pts = set()
        for (a, b), c in edge_count.items():
            if c == 1:
                rim_pts.add(a)
                rim_pts.add(b)
        baffle_pts = sorted(set(int(q) for f in face_ids for q in fpts[f])
                            - rim_pts)

        # cell -> faces (on the NEW face list) for the side flood fill
        n_new = len(new_faces)
        cell_faces: Dict[int, List[int]] = {}
        for i in range(n_new):
            cell_faces.setdefault(int(new_owner[i]), []).append(i)
            if i < n_internal:
                cell_faces.setdefault(int(new_neigh[i]), []).append(i)

        slave_set = set(slave_side)
        extra = []
        for q in baffle_pts:
            # cells around q, connected through internal faces only
            # (the baffle no longer connects its two sides)
            cells = set()
            for i in range(n_new):
                if q in new_faces[i]:
                    cells.add(int(new_owner[i]))
                    if i < n_internal:
                        cells.add(int(new_neigh[i]))
            # seed: owner cells of slave-side faces at q
            seed = set(int(new_owner[i]) for i in slave_side
                       if q in new_faces[i])
            comp = set(seed)
            stack = list(seed)
            while stack:
                c = stack.pop()
                for i in cell_faces.get(c, ()):
                    if i >= n_internal or q not in new_faces[i]:
                        continue
                    for c2 in (int(new_owner[i]), int(new_neigh[i])):
                        if c2 in cells and c2 not in comp:
                            comp.add(c2)
                            stack.append(c2)
            if comp == cells:
                continue  # sides still connected around this point
            q2 = len(points) + len(extra)
            extra.append(points[q])
            # faces of the slave-side component switch to q2
            for i in range(n_new):
                if q not in new_faces[i]:
                    continue
                oc = int(new_owner[i])
                on_slave = (oc in comp) or (
                    i < n_internal and int(new_neigh[i]) in comp)
                if i in slave_set or (on_slave and i not in owner_side):
                    face = new_faces[i]
                    face[face == q] = q2
        if extra:
            points = np.concatenate([points, np.stack(extra)])

    flat2 = np.concatenate(new_faces)
    offsets2 = np.zeros(len(new_faces) + 1, dtype=np.int64)
    np.cumsum([len(f) for f in new_faces], out=offsets2[1:])
    out = PolyMesh(points=points, face_flat=flat2,
                   face_offsets=offsets2,
                   owner=np.asarray(new_owner, np.int64),
                   neighbour=np.asarray(new_neigh, np.int64),
                   patches=patches)
    out.validate()
    return out
