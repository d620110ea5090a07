"""Multi-block structured hex mesh generator (blockMesh equivalent).

Covers the subset of OpenFOAM blockMesh needed to regenerate the
reference testcase2 fixture (testcase2/system/blockMeshDict): multiple
hex blocks over a shared vertex list, per-axis cell counts and simple
expansion-ratio grading, automatic merging of coincident block faces,
boundary patches declared as 4-vertex quads, and *projected* block
faces (vertices/faces projected onto an analytic surface with the
bulge displacement decaying linearly into the block — the straight-
edge approximation of blockMesh's projectFace/projectCurve).

Host-side fixture tooling, not on the device hot path.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from smoothmesh_torch.io.polymesh import Patch, PolyMesh
from smoothmesh_torch.mesh.blockmesh import _axis_coords

# Outward-winding local faces of the OpenFOAM hex (c0..c7), by side
_SIDES = {
    "xmin": (0, 4, 7, 3),
    "xmax": (1, 2, 6, 5),
    "ymin": (0, 1, 5, 4),
    "ymax": (3, 7, 6, 2),
    "zmin": (0, 3, 2, 1),
    "zmax": (4, 5, 6, 7),
}


def _block_points(verts8: np.ndarray, n: Sequence[int],
                  grading: Sequence[float],
                  proj_sides: Dict[str, Callable]) -> np.ndarray:
    """(nx+1, ny+1, nz+1, 3) lattice: trilinear in the 8 corners plus
    projected-face bulges decaying linearly to the opposite face."""
    nx, ny, nz = n
    u = _axis_coords(nx, grading[0])
    v = _axis_coords(ny, grading[1])
    w = _axis_coords(nz, grading[2])
    U, V, W = np.meshgrid(u, v, w, indexing="ij")
    c = verts8

    def tri(U, V, W):
        return (
            c[0] * ((1 - U) * (1 - V) * (1 - W))[..., None]
            + c[1] * (U * (1 - V) * (1 - W))[..., None]
            + c[2] * (U * V * (1 - W))[..., None]
            + c[3] * ((1 - U) * V * (1 - W))[..., None]
            + c[4] * ((1 - U) * (1 - V) * W)[..., None]
            + c[5] * (U * (1 - V) * W)[..., None]
            + c[6] * (U * V * W)[..., None]
            + c[7] * ((1 - U) * V * W)[..., None]
        )

    P = tri(U, V, W)
    for side, proj in proj_sides.items():
        # face coordinate + decay weight toward the opposite face
        axis, at_max = {"xmin": (0, False), "xmax": (0, True),
                        "ymin": (1, False), "ymax": (1, True),
                        "zmin": (2, False), "zmax": (2, True)}[side]
        coord = (U, V, W)[axis]
        face_t = 1.0 if at_max else 0.0
        # bulge on the straight-edge face lattice
        sel = [slice(None)] * 3
        sel[axis] = -1 if at_max else 0
        base = P[tuple(sel)]                       # (na+1, nb+1, 3)
        bulge = proj(base.reshape(-1, 3)).reshape(base.shape) - base
        decay = 1.0 - np.abs(coord - face_t)       # 1 at face, 0 opposite
        # broadcast bulge across the block axis
        exp = np.expand_dims(bulge, axis=axis)
        P = P + exp * decay[..., None]
    return P


def multi_block(
    vertices: np.ndarray,
    blocks: Sequence[Sequence[int]],
    counts: Sequence[Sequence[int]],
    patches: Sequence[Tuple[str, str, Sequence[Sequence[int]]]],
    gradings: Optional[Sequence] = None,
    projections: Optional[Dict[int, Callable]] = None,
    project_faces: Optional[Sequence[Tuple[Sequence[int], int]]] = None,
    default_name: str = "defaultFaces",
    merge_tol: float = 1e-7,
) -> PolyMesh:
    """Build a conforming multi-block hex mesh.

    vertices: (V, 3); blocks: (B, 8) OpenFOAM hex vertex ordering;
    counts: (B, 3) cells per block axis; patches: ordered
    (name, type, [quad of vertex ids, ...]); gradings: per block a
    3-tuple of expansion ratios (default uniform); projections:
    {projector id: callable (N,3)->(N,3)}; project_faces: list of
    (quad of vertex ids, projector id) — vertices named by a projected
    face are snapped by the projector too (blockMesh ``project`` on
    vertices + faces).  Coincident lattice points across blocks merge
    by rounded-coordinate identity (blocks must agree on shared-face
    resolution, like blockMesh).
    """
    vertices = np.asarray(vertices, np.float64).copy()
    blocks = np.asarray(blocks, np.int64)
    counts = np.asarray(counts, np.int64)
    B = len(blocks)
    if gradings is None:
        gradings = [(1.0, 1.0, 1.0)] * B
    projections = projections or {}
    project_faces = project_faces or []

    # project the named vertices themselves
    proj_vsets = []
    for quad, pid in project_faces:
        proj = projections[pid]
        ids = np.asarray(quad, np.int64)
        vertices[ids] = proj(vertices[ids])
        proj_vsets.append((frozenset(int(q) for q in quad), pid))

    # map projected face quads -> (block, side)
    def block_side_sets(b):
        out = {}
        for side, loc in _SIDES.items():
            out[side] = frozenset(int(blocks[b][i]) for i in loc)
        return out

    # generate per-block lattices
    all_pts: List[np.ndarray] = []
    block_grids: List[np.ndarray] = []
    offset = 0
    for b in range(B):
        sides = block_side_sets(b)
        proj_sides = {}
        for fs, pid in proj_vsets:
            for side, ss in sides.items():
                if ss == fs:
                    proj_sides[side] = projections[pid]
        P = _block_points(vertices[blocks[b]], counts[b], gradings[b],
                          proj_sides)
        all_pts.append(P.reshape(-1, 3))
        block_grids.append(P)
        offset += P.size // 3

    pts_cat = np.concatenate(all_pts)
    key = np.round(pts_cat / merge_tol).astype(np.int64)
    _, first, inv = np.unique(key, axis=0, return_index=True,
                              return_inverse=True)
    points = pts_cat[first]
    gid_of = inv  # local concat idx -> global point id

    # global ids per block lattice
    gids: List[np.ndarray] = []
    off = 0
    for b in range(B):
        sz = block_grids[b].shape[:3]
        n = sz[0] * sz[1] * sz[2]
        gids.append(gid_of[off: off + n].reshape(sz))
        off += n

    # cells: 8 corner ids each + provenance
    hexes = []
    cell_block = []
    for b in range(B):
        g = gids[b]
        c0 = g[:-1, :-1, :-1]
        c1 = g[1:, :-1, :-1]
        c2 = g[1:, 1:, :-1]
        c3 = g[:-1, 1:, :-1]
        c4 = g[:-1, :-1, 1:]
        c5 = g[1:, :-1, 1:]
        c6 = g[1:, 1:, 1:]
        c7 = g[:-1, 1:, 1:]
        hx = np.stack([c.reshape(-1) for c in
                       (c0, c1, c2, c3, c4, c5, c6, c7)], axis=1)
        hexes.append(hx)
        cell_block.append(np.full(len(hx), b))
    hexes = np.concatenate(hexes)
    cell_block = np.concatenate(cell_block)
    n_cells = len(hexes)

    # all candidate faces with outward winding + provenance
    side_names = list(_SIDES)
    fquads = np.stack([hexes[:, list(_SIDES[s])] for s in side_names],
                      axis=1)                       # (C, 6, 4)
    fquads = fquads.reshape(-1, 4)
    fcell = np.repeat(np.arange(n_cells), 6)
    fside = np.tile(np.arange(6), n_cells)

    skey = np.sort(fquads, axis=1)
    uniq, inv2, cnt = np.unique(skey, axis=0, return_inverse=True,
                                return_counts=True)
    order = np.argsort(inv2, kind="stable")
    # for each unique face: one or two entries
    starts = np.zeros(len(uniq) + 1, dtype=np.int64)
    np.cumsum(cnt, out=starts[1:])

    int_faces, int_owner, int_neigh = [], [], []
    bnd_faces, bnd_owner, bnd_block_side = [], [], []
    for ui in range(len(uniq)):
        ent = order[starts[ui]: starts[ui + 1]]
        if len(ent) == 2:
            a, bb = ent
            if fcell[a] > fcell[bb]:
                a, bb = bb, a
            int_faces.append(fquads[a])
            int_owner.append(fcell[a])
            int_neigh.append(fcell[bb])
        elif len(ent) == 1:
            a = ent[0]
            bnd_faces.append(fquads[a])
            bnd_owner.append(fcell[a])
            bnd_block_side.append((int(cell_block[fcell[a]]),
                                   side_names[fside[a]]))
        else:
            raise ValueError("face shared by >2 cells (bad blocks)")

    # patch assignment: (block, side) whose corner-vertex set matches a
    # declared patch quad
    bs_to_patch: Dict[Tuple[int, str], int] = {}
    for pi, (_, _, quads) in enumerate(patches):
        qsets = [frozenset(int(q) for q in quad) for quad in quads]
        for b in range(B):
            for side, ss in block_side_sets(b).items():
                if ss in qsets:
                    bs_to_patch[(b, side)] = pi

    assign = np.array([bs_to_patch.get(bs, len(patches))
                       for bs in bnd_block_side])
    order_b = np.argsort(assign, kind="stable")

    out_patches: List[Patch] = []
    pos = len(int_faces)
    names = [(n, t) for n, t, _ in patches] + [(default_name, "patch")]
    for pi, (nm, tp) in enumerate(names):
        k = int((assign == pi).sum())
        if k == 0 and pi == len(patches):
            continue
        out_patches.append(Patch(name=nm, type=tp, n_faces=k,
                                 start_face=pos))
        pos += k

    all_faces = int_faces + [bnd_faces[i] for i in order_b]
    owner = np.asarray(int_owner
                       + [bnd_owner[i] for i in order_b], np.int64)
    flat = np.concatenate(all_faces)
    offsets = np.arange(len(all_faces) + 1, dtype=np.int64) * 4
    mesh = PolyMesh(points=points, face_flat=flat.astype(np.int64),
                    face_offsets=offsets, owner=owner,
                    neighbour=np.asarray(int_neigh, np.int64),
                    patches=out_patches)
    mesh.validate()
    return mesh


def sphere_projector(radius: float = 1.0,
                     centre: Sequence[float] = (0.0, 0.0, 0.0)):
    c = np.asarray(centre, np.float64)

    def proj(pts: np.ndarray) -> np.ndarray:
        d = pts - c
        r = np.linalg.norm(d, axis=1, keepdims=True)
        return c + d * (radius / np.maximum(r, 1e-300))

    return proj
