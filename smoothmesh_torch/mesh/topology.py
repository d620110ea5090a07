"""The mesh compiler: polyMesh -> padded-CSR int32 arrays.

Every adjacency the smoother reads (pointCells, pointPoints,
pointFaces, pointEdges, edgeFaces, edgeCells, cellFaces — OpenFOAM's
lazily built ragged connectivity) becomes a fixed-width padded index
array plus a validity mask, built once on the host with numpy.  The
kernels then read these tables directly: one thread per consumer
entity walks its padded row, so every reduction happens on the consumer
side, without scatters or atomics.

Design notes (deliberate deviations from the reference, same semantics):
  - ``pointNeighPoints`` (reference src/smoothMesh.C:190-217) is not
    materialized: its only consumer, the "two closest points share a
    cell" test, intersects the two points' ``point_cells`` rows instead.
  - ``findCellFacePair`` (reference src/smoothMesh.C:1042-1097) is
    precompiled into per-edge (cell -> face pair) slot tables.
  - The native path (the default, ``smoothmesh_torch.native``) numbers
    edges and orders the entries of each row by first appearance; the
    numpy path (``use_native=False``) orders edges lexicographically by
    (min point, max point) and sorts each row.  Both leave every row
    left-packed (:func:`rows_not_left_packed`).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Tuple

import numpy as np

from smoothmesh_torch import native as native_lib
from smoothmesh_torch.io.polymesh import PolyMesh


def pad_groups(
    keys: np.ndarray,
    nrows: int,
    *vals: np.ndarray,
    dedupe_key: Optional[np.ndarray] = None,
    min_width: int = 1,
) -> Tuple[np.ndarray, ...]:
    """Group ``vals`` by ``keys`` into padded (nrows, maxdeg) arrays.

    Returns ``(mask, v0_padded, v1_padded, ...)``; padded entries are 0
    with ``mask`` False.  Rows are ordered by key; within a row, entries
    are ordered by (dedupe_key or first value).  If ``dedupe_key`` is
    given, duplicate (key, dedupe_key) pairs are dropped.
    """
    keys = np.asarray(keys, dtype=np.int64)
    vals_arr = [np.asarray(v) for v in vals]
    if dedupe_key is not None:
        dk = np.asarray(dedupe_key, dtype=np.int64)
        combo = keys * (dk.max(initial=0) + 1) + dk
        _, order = np.unique(combo, return_index=True)
        keys = keys[order]
        vals_arr = [v[order] for v in vals_arr]
    else:
        sort_v = vals_arr[0] if vals_arr else np.zeros_like(keys)
        order = np.lexsort((np.asarray(sort_v, dtype=np.int64)
                            if sort_v.ndim == 1 else np.arange(len(keys)),
                            keys))
        keys = keys[order]
        vals_arr = [v[order] for v in vals_arr]
    counts = np.bincount(keys, minlength=nrows)
    width = max(int(counts.max(initial=0)), min_width)
    offsets = np.zeros(nrows + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    slot = np.arange(len(keys)) - offsets[keys]
    mask = np.zeros((nrows, width), dtype=bool)
    mask[keys, slot] = True
    out = [mask]
    for v in vals_arr:
        shape = (nrows, width) + v.shape[1:]
        p = np.zeros(shape, dtype=v.dtype)
        p[keys, slot] = v
        out.append(p)
    return tuple(out)


def boundary_point_mask(mesh: PolyMesh) -> np.ndarray:
    """True for points on any non-processor, non-empty boundary patch.

    Complement of the reference's ``findInternalMeshPoints``
    (src/smoothMesh.C:40-91).  Raises on ``empty`` patches (2D meshes
    are unsupported, matching the reference fatal error :61-66).
    """
    is_boundary = np.zeros(mesh.n_points, dtype=bool)
    for p in mesh.patches:
        if p.is_processor:
            continue
        if p.is_empty:
            raise ValueError(
                "Smoothing of non-3D meshes (meshes with type empty patches)"
                " is not supported"
            )
        for f in range(p.start_face, p.start_face + p.n_faces):
            is_boundary[mesh.face_points(f)] = True
    return is_boundary


@dataclasses.dataclass
class MeshTopology:
    """Padded static-shape connectivity for one mesh.

    All index arrays are int32 with 0-padding; each has a matching
    boolean mask.  Naming follows OpenFOAM's accessors.
    """

    n_points: int
    n_cells: int
    n_faces: int
    n_internal_faces: int
    n_edges: int

    # faces
    face_points: np.ndarray       # (F, maxFP) point ids
    face_points_next: np.ndarray  # (F, maxFP) next point in face (cyclic)
    face_mask: np.ndarray         # (F, maxFP)
    face_npoints: np.ndarray      # (F,)
    owner: np.ndarray             # (F,)
    neighbour: np.ndarray         # (F,) -1-padded -> stored 0 with mask
    has_neighbour: np.ndarray     # (F,) bool

    # edges
    edges: np.ndarray             # (E, 2) point ids
    edge_faces: np.ndarray        # (E, maxEF)
    edge_faces_mask: np.ndarray
    edge_cells: np.ndarray        # (E, maxEC)
    edge_cells_mask: np.ndarray
    edge_cell_f0: np.ndarray      # (E, maxEC) slot into edge_faces row
    edge_cell_f1: np.ndarray      # (E, maxEC)

    # point adjacency
    point_points: np.ndarray      # (N, maxPP)
    point_points_mask: np.ndarray
    point_cells: np.ndarray       # (N, maxPC)
    point_cells_mask: np.ndarray
    point_faces: np.ndarray       # (N, maxPF)
    point_faces_mask: np.ndarray
    point_edges: np.ndarray       # (N, maxPE)
    point_edges_mask: np.ndarray
    point_edges_side: np.ndarray  # (N, maxPE) which endpoint slot the
                                  # point occupies in each of its edges
    # edge-angle wedges: for each (point, face) incidence, the previous
    # and next point in that face's perimeter (reference
    # getNeighbourPoints, src/smoothMesh.C:793-831)
    wedge_prev: np.ndarray        # (N, maxPF)
    wedge_next: np.ndarray        # (N, maxPF)

    # cells
    cell_faces: np.ndarray        # (C, maxCF)
    cell_faces_mask: np.ndarray

    # boundary
    is_internal_point: np.ndarray   # (N,) bool
    face_patch: np.ndarray          # (F,) patch id, -1 for internal
    patch_names: Tuple[str, ...]
    patch_types: Tuple[str, ...]

    def patch_ids_matching(self, selectors) -> np.ndarray:
        """Patch ids whose names match any selector (regex or literal).

        Mirrors ``getPatchIdsForOption`` + OpenFOAM patchSet regex
        semantics (reference src/smoothMesh.C:1442-1471).
        """
        out = []
        for i, name in enumerate(self.patch_names):
            if self.patch_types[i] in ("processor", "empty"):
                continue
            for sel in selectors:
                if sel == name or re.fullmatch(sel, name):
                    out.append(i)
                    break
        return np.array(sorted(set(out)), dtype=np.int64)


def compile_topology(mesh: PolyMesh,
                     use_native: bool = True) -> MeshTopology:
    """Build all padded adjacency arrays from a PolyMesh.

    ``use_native`` runs the heavy builds in the C++ O(M) hashing and
    grouping of :mod:`smoothmesh_torch.native` (M = perimeter entries),
    which raises if its library cannot be built or loaded;
    ``use_native=False`` is the numpy path, with O(M log M) sorts.  The
    two paths order edges and the entries within rows differently
    (first appearance against sorted), which only changes floating-point
    summation orders and degenerate tie-breaks.
    """
    native = native_lib if use_native else None
    N = mesh.n_points
    F = mesh.n_faces
    Fi = mesh.n_internal_faces
    C = mesh.n_cells

    # All intermediates are int32: every entity id fits 2^31 up to
    # ~170M cells.  Offsets stay int64.
    if mesh.face_flat.size >= 2**31:
        raise ValueError(
            "compile_topology: mesh exceeds int32 id range "
            f"({mesh.face_flat.size:,} perimeter entries >= 2^31); "
            "meshes this large (>170M cells) need a partitioned setup")
    flat = mesh.face_flat.astype(np.int32)
    offs = mesh.face_offsets.astype(np.int64)
    counts = np.diff(offs).astype(np.int32)
    face_of_entry = np.repeat(np.arange(F, dtype=np.int32), counts)

    # face_points (+ cyclic next), preserving perimeter order by slot
    offs32 = offs.astype(np.int32)   # values <= M < 2^31
    slot = np.arange(len(flat), dtype=np.int32) - offs32[face_of_entry]
    width = int(counts.max())
    face_points = np.zeros((F, width), dtype=np.int32)
    face_mask = np.zeros((F, width), dtype=bool)
    face_points[face_of_entry, slot] = flat
    face_mask[face_of_entry, slot] = True
    nxt_slot = slot + 1
    wrap = nxt_slot >= counts[face_of_entry]
    nxt_slot[wrap] = 0
    face_points_next = np.zeros((F, width), dtype=np.int32)
    face_points_next[face_of_entry, slot] = flat[offs32[face_of_entry]
                                                 + nxt_slot]
    del wrap

    owner = mesh.owner.astype(np.int32)
    neighbour_full = np.full(F, -1, dtype=np.int32)
    neighbour_full[:Fi] = mesh.neighbour.astype(np.int32)
    has_neighbour = neighbour_full >= 0

    # Edges: undirected unique pairs from face perimeters
    if native is not None:
        edges, edge_of_pair = native.build_edges(flat, offs, N)
        E = len(edges)
    else:
        pair_a = flat.astype(np.int64)
        pair_b = flat[offs32[face_of_entry] + nxt_slot].astype(np.int64)
        lo = np.minimum(pair_a, pair_b)
        hi = np.maximum(pair_a, pair_b)
        pair_key = lo * N + hi
        uniq_keys, edge_of_pair = np.unique(pair_key, return_inverse=True)
        E = len(uniq_keys)
        edges = np.stack([uniq_keys // N, uniq_keys % N],
                         axis=1).astype(np.int32)
        edge_of_pair = edge_of_pair.astype(np.int32)
        del pair_a, pair_b, lo, hi, pair_key, uniq_keys
    del nxt_slot

    # edge_faces: an edge appears once per face perimeter, so (edge,
    # face) pairs are already unique per face
    if native is not None:
        ef_mask, edge_faces = native.pad_groups_native(edge_of_pair, E,
                                                       face_of_entry)
    else:
        ef_mask, edge_faces = pad_groups(edge_of_pair, E, face_of_entry,
                                         dedupe_key=face_of_entry)

    # edge_cells: union of owner/neighbour cells over edge faces
    foe_has_n = has_neighbour[face_of_entry]
    ec_e = np.concatenate([edge_of_pair, edge_of_pair[foe_has_n]])
    ec_c = np.concatenate([owner[face_of_entry],
                           neighbour_full[face_of_entry][foe_has_n]])
    if native is not None:
        ec_mask, edge_cells = native.pad_groups_native(ec_e, E, ec_c,
                                                       dedupe=True)
    else:
        ec_mask, edge_cells = pad_groups(ec_e, E, ec_c, dedupe_key=ec_c)
    del ec_e, ec_c

    # Per-edge per-cell face pair slots (replaces findCellFacePair)
    if native is not None:
        edge_cell_f0, edge_cell_f1 = native.edge_cell_face_pairs(
            edge_faces, ef_mask, edge_cells, ec_mask, owner, neighbour_full)
    else:
        edge_cell_f0, edge_cell_f1 = _edge_cell_face_pairs(
            edge_faces, ef_mask, edge_cells, ec_mask, owner, neighbour_full)

    # point adjacency
    pp_mask, point_points = pad_groups(
        np.concatenate([edges[:, 0], edges[:, 1]]), N,
        np.concatenate([edges[:, 1], edges[:, 0]]),
    )
    e_ids = np.arange(E, dtype=np.int32)
    pe_mask, point_edges = pad_groups(
        np.concatenate([edges[:, 0], edges[:, 1]]), N,
        np.concatenate([e_ids, e_ids]),
    )
    del e_ids
    # side table: which endpoint slot (0/1) the point occupies in each
    # of its edges
    point_edges_side = np.where(
        edges[point_edges, 0] == np.arange(N, dtype=np.int32)[:, None],
        np.int32(0), np.int32(1))
    pf_mask, point_faces, wedge_prev_arr, wedge_next_arr = _point_faces_wedges(
        flat, offs, counts, face_of_entry, slot, N, native
    )
    del slot
    # point_cells via (cell, point) incidence from faces
    pc_pt = np.concatenate([flat, flat[foe_has_n]])
    pc_cl = np.concatenate([owner[face_of_entry],
                            neighbour_full[face_of_entry][foe_has_n]])
    del foe_has_n
    if native is not None:
        pc_mask, point_cells = native.pad_groups_native(pc_pt, N, pc_cl,
                                                        dedupe=True)
    else:
        pc_mask, point_cells = pad_groups(pc_pt, N, pc_cl, dedupe_key=pc_cl)
    del pc_pt, pc_cl, flat, face_of_entry, edge_of_pair

    # cell_faces
    f_ids = np.arange(F, dtype=np.int32)
    cf_c = np.concatenate([owner, neighbour_full[has_neighbour]])
    cf_f = np.concatenate([f_ids, f_ids[has_neighbour]])
    del f_ids
    if native is not None:
        cf_mask, cell_faces = native.pad_groups_native(cf_c, C, cf_f)
    else:
        cf_mask, cell_faces = pad_groups(cf_c, C, cf_f, dedupe_key=cf_f)
    del cf_c, cf_f

    # boundary classification
    face_patch = np.full(F, -1, dtype=np.int32)
    for pid, p in enumerate(mesh.patches):
        face_patch[p.start_face: p.start_face + p.n_faces] = pid
    is_internal = ~boundary_point_mask(mesh)

    def i32(a):
        return a.astype(np.int32, copy=False)

    return MeshTopology(
        n_points=N, n_cells=C, n_faces=F, n_internal_faces=Fi, n_edges=E,
        face_points=i32(face_points),
        face_points_next=i32(face_points_next),
        face_mask=face_mask,
        face_npoints=i32(counts),
        owner=i32(owner),
        neighbour=i32(np.maximum(neighbour_full, 0)),
        has_neighbour=has_neighbour,
        edges=i32(edges),
        edge_faces=i32(edge_faces),
        edge_faces_mask=ef_mask,
        edge_cells=i32(edge_cells),
        edge_cells_mask=ec_mask,
        edge_cell_f0=i32(edge_cell_f0),
        edge_cell_f1=i32(edge_cell_f1),
        point_points=i32(point_points),
        point_points_mask=pp_mask,
        point_cells=i32(point_cells),
        point_cells_mask=pc_mask,
        point_faces=i32(point_faces),
        point_faces_mask=pf_mask,
        point_edges=i32(point_edges),
        point_edges_mask=pe_mask,
        point_edges_side=i32(point_edges_side),
        wedge_prev=i32(wedge_prev_arr),
        wedge_next=i32(wedge_next_arr),
        cell_faces=i32(cell_faces),
        cell_faces_mask=cf_mask,
        is_internal_point=is_internal,
        face_patch=i32(face_patch),
        patch_names=tuple(p.name for p in mesh.patches),
        patch_types=tuple(p.type for p in mesh.patches),
    )


def _edge_cell_face_pairs(edge_faces, ef_mask, edge_cells, ec_mask, owner,
                          neighbour_full):
    """numpy: per-(edge, cell slot) slots of the edge's two faces in
    that cell -> (f0, f1); raises on a mesh sanity violation."""
    f_owner = owner[edge_faces]                  # (E, maxEF)
    f_neigh = neighbour_full[edge_faces]
    # membership[e, c, f]: face f of edge e belongs to cell slot c
    member = (
        (edge_cells[:, :, None] == f_owner[:, None, :])
        | (edge_cells[:, :, None] == f_neigh[:, None, :])
    )
    member &= ec_mask[:, :, None] & ef_mask[:, None, :]
    n_member = member.sum(axis=2)
    if np.any(n_member[ec_mask] != 2):
        bad = np.argwhere((n_member != 2) & ec_mask)
        raise ValueError(
            "mesh sanity: edge/cell with != 2 adjacent edge-faces: "
            f"{bad[:5]}"
        )
    f0 = member.argmax(axis=2)
    np.put_along_axis(member, f0[:, :, None], False, axis=2)
    return f0, member.argmax(axis=2)


def _point_faces_wedges(flat, offs, counts, face_of_entry, slot, N,
                        native=None):
    """point_faces plus per-incidence wedge neighbours (prev/next in face)."""
    offs32 = offs.astype(np.int32)   # values <= M < 2^31
    prv_slot = slot - 1
    prv_slot[prv_slot < 0] = counts[face_of_entry[prv_slot < 0]] - 1
    nxt_slot = slot + 1
    wrap = nxt_slot >= counts[face_of_entry]
    nxt_slot[wrap] = 0
    prev_pt = flat[offs32[face_of_entry] + prv_slot]
    next_pt = flat[offs32[face_of_entry] + nxt_slot]
    if native is not None:
        # three order-preserving fills land in aligned slots
        mask, pfaces = native.pad_groups_native(flat, N, face_of_entry)
        _, wprev = native.pad_groups_native(flat, N, prev_pt)
        _, wnext = native.pad_groups_native(flat, N, next_pt)
        return mask, pfaces, wprev, wnext
    return pad_groups(flat, N, face_of_entry, prev_pt, next_pt,
                      dedupe_key=None)


#: (mask, table) pairs of the padded rows
ROW_MASKS = ("face_mask", "edge_faces_mask", "edge_cells_mask",
             "point_points_mask", "point_cells_mask", "point_faces_mask",
             "point_edges_mask", "cell_faces_mask")


def rows_not_left_packed(topo: MeshTopology) -> list:
    """The row masks of ``topo`` in which some row is not left-packed
    (mask != arange(W) < count, what K3 and the slot loops assume)."""
    bad = []
    for name in ROW_MASKS:
        m = getattr(topo, name)
        if not np.array_equal(
                m, np.arange(m.shape[1]) < m.sum(axis=1)[:, None]):
            bad.append(name)
    return bad
