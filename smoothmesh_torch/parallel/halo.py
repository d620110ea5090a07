"""The halo (overlap) domain decomposition and its smoother.

Points are partitioned into owned sets, one owner a point, and each
shard holds the vertex-complete 1-ring of its owned points: every cell
that contains an owned point, with all of that cell's faces, edges and
points.  Every owned point's stencil is then local and complete, so
each shard runs the unchanged single-device iteration
(``driver.iteration_body``) and exact owned results need only three
exchanges an iteration (:mod:`smoothmesh_torch.parallel.sync`): the
proposal consensus, the freeze OR-combines and the scalar all-reduces.
This is the JAX package's ``smoothmesh_tpu/parallel/halo.py``, whose
shards run one program each under ``jax.shard_map``.

Here the shards run in one of two ways:

  - all on one device (:class:`UnionSync`): the shards' tables are
    concatenated into one *union* topology, every entity id offset by
    its shard's base, so each kernel launches once an iteration over
    all the shards together, and the batched driver's CUDA graph
    carries the halo iteration unchanged;
  - one shard a rank over ``torch.distributed`` (:class:`DistSync`).

The host part (:func:`extract_submesh`, :func:`pad_topology`,
:func:`build_halo_shards`) is numpy and builds the same shards as the
JAX package's, each compiled by this package's topology compiler.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from smoothmesh_torch import layers as lay
from smoothmesh_torch.boundary import BoundarySetup, check_edge_mesh_sanity
from smoothmesh_torch.boundary import classify_boundary_points
from smoothmesh_torch.device import resolve_device
from smoothmesh_torch.driver import Smoother
from smoothmesh_torch.io.polymesh import Patch, PolyMesh
from smoothmesh_torch.mesh.tiling import permute_mesh
from smoothmesh_torch.mesh.topology import (MeshTopology,
                                            boundary_point_mask,
                                            compile_topology)
from smoothmesh_torch.params import SmoothingParams
from smoothmesh_torch.parallel import scatter
from smoothmesh_torch.parallel.partition import partition_cells
from smoothmesh_torch.parallel.sync import DistSync, UnionSync
from smoothmesh_torch.quality import (CUDA_QUALITY_TD_KEYS, QUALITY_TD_KEYS,
                                      MeshStats, combine_quality_parts,
                                      quality_report_parts)

KB = 2048   # entity-count rounding of the padded shards (the JAX package's)


# ---------------------------------------------------------------------------
# Submesh extraction (vertex-complete local cell sets)
# ---------------------------------------------------------------------------

def extract_submesh(mesh: PolyMesh, cell_mask: np.ndarray,
                    face_patch: np.ndarray):
    """Extract the submesh of ``cell_mask`` cells.

    Faces with exactly one local cell become a ``procBoundary``
    processor patch; faces are flipped when their global owner is
    off-shard so the local owner is always local (outward normals
    preserved).  Returns (local PolyMesh, point l2g, cell l2g).
    """
    F = mesh.n_faces
    Fi = mesh.n_internal_faces
    owner = mesh.owner
    neighbour = mesh.neighbour
    flat = mesh.face_flat
    offs = mesh.face_offsets

    own_in = cell_mask[owner]
    nei_in = np.zeros(F, dtype=bool)
    nei_in[:Fi] = cell_mask[neighbour]
    touch = own_in | nei_in
    face_ids = np.where(touch)[0]

    is_internal_local = own_in[face_ids] & nei_in[face_ids]
    is_proc = (face_ids < Fi) & ~is_internal_local
    n_patches = len(mesh.patches)
    order = np.argsort(
        np.where(is_internal_local, 0,
                 np.where(is_proc, 2 + n_patches,
                          1 + face_patch[face_ids])),
        kind="stable",
    )
    face_ids = face_ids[order]
    is_internal_local = is_internal_local[order]
    is_proc = is_proc[order]

    counts = offs[face_ids + 1] - offs[face_ids]
    starts = offs[face_ids]
    out_off = np.zeros(len(face_ids) + 1, dtype=np.int64)
    np.cumsum(counts, out=out_off[1:])
    total = int(out_off[-1])
    rep_row = np.repeat(np.arange(len(face_ids)), counts)
    within = np.arange(total, dtype=np.int64) - out_off[rep_row]
    sel_entries = flat[starts[rep_row] + within]
    gids = np.unique(sel_entries)
    g2l = np.full(mesh.n_points, -1, dtype=np.int64)
    g2l[gids] = np.arange(len(gids))

    cell_ids = np.where(cell_mask)[0]
    c2l = np.full(mesh.n_cells, -1, dtype=np.int64)
    c2l[cell_ids] = np.arange(len(cell_ids))

    o = owner[face_ids]
    if Fi > 0:
        n = np.where(face_ids < Fi,
                     neighbour[np.minimum(face_ids, Fi - 1)], -1)
    else:
        n = np.full(len(face_ids), -1, dtype=np.int64)
    flips = ~cell_mask[o]
    within_f = np.where(flips[rep_row],
                        counts[rep_row] - 1 - within, within)
    new_flat = g2l[flat[starts[rep_row] + within_f]]
    new_owner = c2l[np.where(flips, n, o)]
    new_neighbour = c2l[np.where(flips, o, n)[is_internal_local]]

    patches = []
    fp = face_patch[face_ids]
    pos = int(is_internal_local.sum())
    for pid, p in enumerate(mesh.patches):
        cnt = int(((fp == pid) & ~is_internal_local & ~is_proc).sum())
        patches.append(Patch(name=p.name, type=p.type, n_faces=cnt,
                             start_face=pos))
        pos += cnt
    n_proc = int(is_proc.sum())
    patches.append(Patch(name="procBoundary", type="processor",
                         n_faces=n_proc, start_face=pos))

    lmesh = PolyMesh(
        points=mesh.points[gids],
        face_flat=np.asarray(new_flat, dtype=np.int64),
        face_offsets=out_off,
        owner=np.asarray(new_owner, dtype=np.int64),
        neighbour=np.asarray(new_neighbour, dtype=np.int64),
        patches=patches,
    )
    return lmesh, gids, cell_ids


# ---------------------------------------------------------------------------
# Topology padding to common shapes
# ---------------------------------------------------------------------------

def _pad_rows(a: np.ndarray, n: int, fill=0) -> np.ndarray:
    if a.shape[0] >= n:
        return a
    pad = np.full((n - a.shape[0],) + a.shape[1:], fill, dtype=a.dtype)
    return np.concatenate([a, pad], axis=0)


def _pad_cols(a: np.ndarray, w: int, fill=0) -> np.ndarray:
    if a.shape[1] >= w:
        return a
    pad = np.full((a.shape[0], w - a.shape[1]) + a.shape[2:], fill,
                  dtype=a.dtype)
    return np.concatenate([a, pad], axis=1)


#: the width group of each padded table (``pad_topology``'s ``widths``)
WIDTH_GROUPS = {
    "face_points": "fp", "face_points_next": "fp", "face_mask": "fp",
    "edge_faces": "ef", "edge_faces_mask": "ef",
    "edge_cells": "ec", "edge_cells_mask": "ec", "edge_cell_f0": "ec",
    "edge_cell_f1": "ec",
    "point_points": "pp", "point_points_mask": "pp",
    "point_cells": "pc", "point_cells_mask": "pc",
    "point_faces": "pf", "point_faces_mask": "pf", "wedge_prev": "pf",
    "wedge_next": "pf",
    "point_edges": "pe", "point_edges_mask": "pe", "point_edges_side": "pe",
    "cell_faces": "cf", "cell_faces_mask": "cf",
}
#: the entity whose rows each table indexes
ROW_ENTITY = {
    "face_points": "face", "face_points_next": "face", "face_mask": "face",
    "face_npoints": "face", "owner": "face", "neighbour": "face",
    "has_neighbour": "face", "face_patch": "face",
    "edges": "edge", "edge_faces": "edge", "edge_faces_mask": "edge",
    "edge_cells": "edge", "edge_cells_mask": "edge", "edge_cell_f0": "edge",
    "edge_cell_f1": "edge",
    "point_points": "point", "point_points_mask": "point",
    "point_cells": "point", "point_cells_mask": "point",
    "point_faces": "point", "point_faces_mask": "point",
    "point_edges": "point", "point_edges_mask": "point",
    "point_edges_side": "point", "wedge_prev": "point", "wedge_next": "point",
    "is_internal_point": "point",
    "cell_faces": "cell", "cell_faces_mask": "cell",
}
#: the entity whose ids each index table holds (offset in the union)
ID_ENTITY = {
    "face_points": "point", "face_points_next": "point", "owner": "cell",
    "neighbour": "cell", "edges": "point", "edge_faces": "face",
    "edge_cells": "cell", "point_points": "point", "point_cells": "cell",
    "point_faces": "face", "point_edges": "edge", "wedge_prev": "point",
    "wedge_next": "point", "cell_faces": "face",
}
#: the fill of padded rows (0 elsewhere; masks False)
ROW_FILL = {"face_npoints": 1, "face_patch": -1}
ENTITIES = ("point", "cell", "face", "edge")


def pad_topology(t: MeshTopology, n_points: int, n_cells: int,
                 n_faces: int, n_edges: int,
                 widths: Dict[str, int]) -> MeshTopology:
    """Pad a compiled topology to common entity counts and table widths.

    Padded rows and slots hold 0 (``face_npoints`` 1, ``face_patch``
    -1) under all-False masks; the ``*_valid_rows`` attributes mark the
    live point, edge and cell rows (read by ``device.to_device``).
    """
    counts = {"point": n_points, "cell": n_cells, "face": n_faces,
              "edge": n_edges}
    kw = {}
    for f in dataclasses.fields(MeshTopology):
        a = getattr(t, f.name)
        if f.name not in ROW_ENTITY:
            kw[f.name] = a
            continue
        if f.name in WIDTH_GROUPS:
            a = _pad_cols(a, widths[WIDTH_GROUPS[f.name]],
                          False if a.dtype == np.bool_ else 0)
        fill = ROW_FILL.get(f.name, False if a.dtype == np.bool_ else 0)
        kw[f.name] = _pad_rows(a, counts[ROW_ENTITY[f.name]], fill)
    kw.update(n_points=n_points, n_cells=n_cells, n_faces=n_faces,
              n_edges=n_edges)
    out = MeshTopology(**kw)
    out.point_valid_rows = _pad_rows(np.ones(t.n_points, dtype=bool),
                                     n_points, False)
    out.edge_valid_rows = _pad_rows(np.ones(t.n_edges, dtype=bool),
                                    n_edges, False)
    out.cell_valid_rows = _pad_rows(np.ones(t.n_cells, dtype=bool),
                                    n_cells, False)
    return out


def _round_kb(n: int) -> int:
    return -(-n // KB) * KB


# ---------------------------------------------------------------------------
# Halo shard build
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HaloShards:
    n_shards: int
    topos: List[MeshTopology]           # per-shard padded local topology
    local_points: np.ndarray            # (D, Npad, 3) initial coords
    owned: np.ndarray                   # (D, Npad) bool: shard owns point
    l2g: List[np.ndarray]               # per shard: local (permuted) -> global
    # Replicated-point routing (points on > 1 shard):
    shared_slot_local: np.ndarray       # (D, S) local idx, else ``oob``
    shared_valid: np.ndarray            # (D, S)
    shared_owner_is_me: np.ndarray      # (D, S)
    point_owner_shard: np.ndarray       # (Nglobal,)
    point_owner_local: np.ndarray       # (Nglobal,) local idx on owner
    oob: int                            # the absent-slot sentinel (Npad)
    # Quality-report claims: each global face/edge/cell is claimed by
    # exactly one shard (the owner shard of its minimum global point
    # id), whose local closure of the entity is complete
    claim_face: np.ndarray = None       # (D, n_faces_pad) bool
    claim_edge: np.ndarray = None       # (D, n_edges_pad) bool
    claim_cell: np.ndarray = None       # (D, n_cells_pad) bool
    # global mesh stats from the shards' edges (each edge is on a shard)
    min_edge_length: float = 0.0
    max_edge_length: float = 0.0
    # (D, 4) live rows of each shard: points, cells, faces, edges
    n_local: np.ndarray = None

    @property
    def n_padded_points(self) -> int:
        return self.local_points.shape[1]


def build_halo_shards(mesh: PolyMesh, n_shards: int,
                      cell_shard: Optional[np.ndarray] = None,
                      times: Optional[dict] = None) -> HaloShards:
    """The halo shards of ``mesh`` (the JAX package's
    ``build_halo_shards``, same arrays): each shard's submesh spatially
    reordered and compiled, padded to common entity counts (multiples
    of :data:`KB`) and widths, with the shared-point routing, the
    quality claims and the edge-length extremes.  ``is_internal_point``
    comes from the global mesh: a shard's own compile sees its
    ``procBoundary`` faces as boundary.  ``times``: a dict that
    receives the seconds of the topology compiles (``"compiles"``)."""
    if cell_shard is None:
        cell_shard = partition_cells(mesh, n_shards)
    D = n_shards
    N, C, F = mesh.n_points, mesh.n_cells, mesh.n_faces
    Fi = mesh.n_internal_faces
    global_internal = ~boundary_point_mask(mesh)

    face_patch = np.full(F, -1, dtype=np.int64)
    for pid, p in enumerate(mesh.patches):
        face_patch[p.start_face: p.start_face + p.n_faces] = pid

    # (point, cell) incidences via faces
    flat = mesh.face_flat
    counts = np.diff(mesh.face_offsets)
    face_of = np.repeat(np.arange(F), counts)
    has_n = np.zeros(F, dtype=bool)
    has_n[:Fi] = True
    inc_pt = np.concatenate([flat, flat[has_n[face_of]]])
    neigh_full = np.full(F, -1, dtype=np.int64)
    neigh_full[:Fi] = mesh.neighbour
    inc_cl = np.concatenate([mesh.owner[face_of],
                             neigh_full[face_of][has_n[face_of]]])

    # point owner: the least shard over the incident cells
    point_owner = np.full(N, D, dtype=np.int64)
    np.minimum.at(point_owner, inc_pt, cell_shard[inc_cl])
    if np.any(point_owner >= D):
        raise ValueError("points without incident cells")

    # local cell sets: every cell containing an owned point
    local = np.zeros((D, C), dtype=bool)
    local[point_owner[inc_pt], inc_cl] = True
    local[cell_shard, np.arange(C)] = True

    topos_raw: List[MeshTopology] = []
    l2g: List[np.ndarray] = []
    pts_list, owned_list = [], []
    claims_raw: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    min_edge, max_edge = np.inf, 0.0
    t_compile = 0.0

    for d in range(D):
        lmesh, gids, _cells = extract_submesh(mesh, local[d], face_patch)
        pmesh, orders = permute_mesh(lmesh)
        t0 = time.perf_counter()
        topo = compile_topology(pmesh)
        t_compile += time.perf_counter() - t0
        gids_perm = gids[orders.point_old]     # new local idx -> global
        topo.is_internal_point = global_internal[gids_perm]
        elen = np.linalg.norm(
            pmesh.points[topo.edges[:, 0]] - pmesh.points[topo.edges[:, 1]],
            axis=1)
        min_edge = min(min_edge, float(elen.min()))
        max_edge = max(max_edge, float(elen.max()))
        # quality claims: entity -> min global point id -> owner shard
        fp_g = np.where(topo.face_mask, gids_perm[topo.face_points], N)
        min_fp = np.minimum(fp_g.min(axis=1), N - 1)
        c_face = point_owner[min_fp] == d
        c_edge = point_owner[gids_perm[topo.edges].min(axis=1)] == d
        cell_min = np.minimum(
            np.where(topo.cell_faces_mask, min_fp[topo.cell_faces],
                     N).min(axis=1), N - 1)
        c_cell = point_owner[cell_min] == d
        claims_raw.append((c_face, c_edge, c_cell))
        topos_raw.append(topo)
        l2g.append(gids_perm)
        pts_list.append(pmesh.points)
        owned_list.append(point_owner[gids_perm] == d)
    if times is not None:
        times["compiles"] = t_compile

    n_pts = _round_kb(max(t.n_points for t in topos_raw))
    n_cls = _round_kb(max(t.n_cells for t in topos_raw))
    n_fcs = _round_kb(max(t.n_faces for t in topos_raw))
    n_edg = _round_kb(max(t.n_edges for t in topos_raw))
    widths = {g: max(getattr(t, f).shape[1] for t in topos_raw)
              for f, g in WIDTH_GROUPS.items()}
    topos = [pad_topology(t, n_pts, n_cls, n_fcs, n_edg, widths)
             for t in topos_raw]
    claim_face = np.stack([_pad_rows(c[0], n_fcs, False)
                           for c in claims_raw])
    claim_edge = np.stack([_pad_rows(c[1], n_edg, False)
                           for c in claims_raw])
    claim_cell = np.stack([_pad_rows(c[2], n_cls, False)
                           for c in claims_raw])
    if int(claim_cell.sum()) != C or int(claim_face.sum()) != F:
        raise AssertionError("quality claims do not cover the mesh")

    pts = np.zeros((D, n_pts, 3))
    owned = np.zeros((D, n_pts), dtype=bool)
    for d in range(D):
        pts[d, :len(pts_list[d])] = pts_list[d]
        owned[d, :len(owned_list[d])] = owned_list[d]

    # replicated points and their routing; absent slots hold n_pts
    oob = n_pts
    count = np.zeros(N, dtype=np.int64)
    for g in l2g:
        count[g] += 1
    shared_gids = np.where(count > 1)[0]
    S = max(len(shared_gids), 1)     # keep collectives non-empty

    slot_local = np.full((D, S), oob, dtype=np.int64)
    valid = np.zeros((D, S), dtype=bool)
    for d, g in enumerate(l2g):
        g2l = np.full(N, -1, dtype=np.int64)
        g2l[g] = np.arange(len(g))
        li = g2l[shared_gids]
        has = li >= 0
        slot_local[d, :len(shared_gids)][has] = li[has]
        valid[d, :len(shared_gids)] = has
    owner_is_me = np.zeros((D, S), dtype=bool)
    owner_is_me[:, :len(shared_gids)] = (
        point_owner[shared_gids][None, :] == np.arange(D)[:, None])

    owner_local = np.full(N, -1, dtype=np.int64)
    for d, g in enumerate(l2g):
        mine = point_owner[g] == d
        owner_local[g[mine]] = np.where(mine)[0]
    if np.any(owner_local < 0):
        raise ValueError("point not present on its owner shard")

    n_local = np.array([[t.n_points, t.n_cells, t.n_faces, t.n_edges]
                        for t in topos_raw], dtype=np.int64)
    return HaloShards(
        n_shards=D, topos=topos, local_points=pts, owned=owned,
        l2g=l2g,
        shared_slot_local=slot_local, shared_valid=valid,
        shared_owner_is_me=owner_is_me,
        point_owner_shard=point_owner,
        point_owner_local=owner_local, oob=oob,
        claim_face=claim_face, claim_edge=claim_edge,
        claim_cell=claim_cell,
        min_edge_length=min_edge, max_edge_length=max_edge,
        n_local=n_local,
    )


# ---------------------------------------------------------------------------
# The union topology: the shards side by side
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HaloUnion:
    """The live rows of some shards concatenated into one topology.

    ``base[i]``: the first union row of ``shards[i]``, per entity
    (point, cell, face, edge), with one more row for the totals.
    Entity ids in the tables are offset by their shard's base; slot
    indices, masks, sides and patch ids are not.  ``n_internal_faces``
    is the count of internal faces (they are not the first rows).
    """

    shards: Tuple[int, ...]
    topo: MeshTopology
    base: np.ndarray              # (len(shards) + 1, 4)
    points: np.ndarray            # (U, 3) the shards' initial points
    owned: np.ndarray             # (U,) bool
    l2g: np.ndarray               # (U,) global point of each union row
    claim_face: np.ndarray
    claim_edge: np.ndarray
    claim_cell: np.ndarray
    # the shared points held here: each (point, holder) pair's union
    # row, its shared-point index, and whether the holder owns it
    pair_rows: np.ndarray
    pair_slots: np.ndarray
    pair_owner: np.ndarray
    n_slots: int

    def owner_rows(self) -> np.ndarray:
        """The owner's union row of each pair's point (every owner is
        here)."""
        row = np.full(self.n_slots, -1, dtype=np.int64)
        row[self.pair_slots[self.pair_owner]] = \
            self.pair_rows[self.pair_owner]
        out = row[self.pair_slots]
        if np.any(out < 0):
            raise ValueError("a shared point's owner is not in the union")
        return out

    def rows(self, blocks: np.ndarray, ids: bool = False) -> np.ndarray:
        """Per-shard point blocks (D, Npad, ...) -> union rows; ``ids``:
        the values are local point ids (>= 0), offset like the tables'."""
        parts = []
        for i, d in enumerate(self.shards):
            n = self.base[i + 1, 0] - self.base[i, 0]
            b = np.asarray(blocks[d][:n])
            if ids:
                b = np.where(b >= 0, b + self.base[i, 0], b)
            parts.append(b)
        return np.concatenate(parts)


def union_topology(sh: HaloShards,
                   shards: Optional[Sequence[int]] = None) -> HaloUnion:
    """The union of ``shards`` (default all) of ``sh``: the live rows of
    each shard's padded topology (common widths), entity ids offset."""
    shards = tuple(range(sh.n_shards) if shards is None else shards)
    n_local = sh.n_local[list(shards)]
    base = np.zeros((len(shards) + 1, 4), dtype=np.int64)
    np.cumsum(n_local, axis=0, out=base[1:])
    col = {e: i for i, e in enumerate(ENTITIES)}
    t0 = sh.topos[shards[0]]
    kw = {}
    for f in dataclasses.fields(MeshTopology):
        if f.name not in ROW_ENTITY:
            continue
        parts = []
        for i, d in enumerate(shards):
            a = getattr(sh.topos[d], f.name)[:n_local[i, col[ROW_ENTITY[
                f.name]]]]
            if f.name in ID_ENTITY:
                a = a + a.dtype.type(base[i, col[ID_ENTITY[f.name]]])
            parts.append(a)
        kw[f.name] = np.concatenate(parts)
    topo = MeshTopology(
        n_points=int(base[-1, 0]), n_cells=int(base[-1, 1]),
        n_faces=int(base[-1, 2]),
        n_internal_faces=int(kw["has_neighbour"].sum()),
        n_edges=int(base[-1, 3]), patch_names=t0.patch_names,
        patch_types=t0.patch_types, **kw)

    def cat(blocks, entity):
        return np.concatenate([blocks[d][:n_local[i, col[entity]]]
                               for i, d in enumerate(shards)])

    rows, slots, owner = [], [], []
    for i, d in enumerate(shards):
        s = np.where(sh.shared_valid[d])[0]
        rows.append(sh.shared_slot_local[d, s] + base[i, 0])
        slots.append(s)
        owner.append(sh.shared_owner_is_me[d, s])
    return HaloUnion(
        shards=shards, topo=topo, base=base,
        points=cat(sh.local_points, "point"),
        owned=cat(sh.owned, "point"),
        l2g=np.concatenate([sh.l2g[d] for d in shards]),
        claim_face=cat(sh.claim_face, "face"),
        claim_edge=cat(sh.claim_edge, "edge"),
        claim_cell=cat(sh.claim_cell, "cell"),
        pair_rows=np.concatenate(rows), pair_slots=np.concatenate(slots),
        pair_owner=np.concatenate(owner),
        n_slots=sh.shared_valid.shape[1])


# ---------------------------------------------------------------------------
# The smoother
# ---------------------------------------------------------------------------

class HaloSmoother(Smoother):
    """Smoothing on the halo decomposition into ``n_shards`` shards.

    The counterpart of the JAX package's ``HaloSmoother``
    (``smoothmesh_tpu/parallel/halo.py:569``; ``n_shards`` stands for
    its ``n_devices``), with the driver's features: the default
    constraints with the face angle, layer blending and boundary
    smoothing.  It is the single-device :class:`Smoother` run on the
    union of the shards with the halo exchanges, so :meth:`steps` (CUDA
    graph replays on the card, one host read a batch), :meth:`step`,
    :meth:`run` and the face-angle rerun are the driver's.

    ``device``: ``"cuda"`` by default (raises without a card); ``"cpu"``
    runs the plain versions.  All shards run on it together
    (:class:`~smoothmesh_torch.parallel.sync.UnionSync`), unless
    ``distributed``: then ``torch.distributed`` must be initialized
    with the gloo backend (NCCL is not supported), ``n_shards`` is its
    world size, and this process runs the shard of its rank on
    ``device`` (:class:`~smoothmesh_torch.parallel.sync.DistSync`,
    eager).

    ``points`` is the union's (U, 3) internal points, the shards' rows
    one after another (``union.base``); :meth:`shard_points` gives the
    JAX class's (D, Npad, 3) blocks and :meth:`denormalize` the global
    mesh in its own point order.  ``setup_times``: the seconds of the
    shard build (of which the topology compiles), the union and the
    upload.
    """

    def __init__(self, mesh: PolyMesh, params: SmoothingParams,
                 n_shards: Optional[int] = None, dtype=None,
                 normalize: bool = True, device=None,
                 distributed: bool = False):
        device = resolve_device(device)
        self._build(mesh, n_shards, distributed)
        if normalize:
            center = mesh.points.mean(axis=0)
            scale = 1.0 / max(self.stats.min_edge_length, 1e-300)
        else:
            center, scale = np.zeros(3), 1.0
        self._start((self.union.points - center) * scale,
                    params.resolve(self.stats.min_edge_length), center,
                    scale, device, dtype)
        if self._will_layer:
            self._setup_maps()
            sh = self.shards
            self._set_layer(scatter.scatter_layer_maps(
                self.layer_maps, sh.l2g,
                scatter.g2l_maps(sh.l2g, mesh.n_points),
                sh.n_padded_points)[0])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.setup_times["upload"] += time.perf_counter() - self._t_upload

    def _build(self, mesh: PolyMesh, n_shards: Optional[int],
               distributed: bool) -> None:
        """The host part: the shards, their union and the mesh stats."""
        times = {}
        if distributed:
            import torch.distributed as dist

            if dist.get_backend() != "gloo":
                raise ValueError("the halo's ranks run on gloo only, not "
                                 f"{dist.get_backend()}")
            rank, world = dist.get_rank(), dist.get_world_size()
            if n_shards not in (None, world):
                raise ValueError(f"n_shards {n_shards} != world size "
                                 f"{world}")
            n_shards, which = world, [rank]
        else:
            n_shards = 1 if n_shards is None else int(n_shards)
            which = None
        t0 = time.perf_counter()
        sh = build_halo_shards(mesh, n_shards, times=times)
        times["shard build"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.union = union_topology(sh, which)
        times["union"] = time.perf_counter() - t0
        mins, maxs = mesh.points.min(0), mesh.points.max(0)
        self.stats = MeshStats(
            sh.min_edge_length, sh.max_edge_length,
            float((maxs[0] - mins[0]) + (maxs[1] - mins[1])
                  + (maxs[2] + mins[2])))
        self.mesh = mesh
        self.mesh_internal = None
        self.shards = sh
        self.distributed = bool(distributed)
        self._global_topo = None
        self.setup_times = times

    def _start(self, points, params, center, scale, device,
               dtype) -> None:
        """The device state of the union from its internal points and
        the resolved parameters, with the exchange."""
        self._t_upload = time.perf_counter()
        self.setup_times["upload"] = 0.0
        un = self.union
        self._setup(un.topo, points, params, center, scale, device, dtype,
                    orders=None)
        self.owned = self._tensor(un.owned, torch.bool)
        idx = self._index
        if self.distributed:
            self.sync = DistSync(idx(un.pair_rows), idx(un.pair_slots),
                                 self._tensor(un.pair_owner, torch.bool),
                                 un.n_slots)
        else:
            self.sync = UnionSync(idx(un.pair_rows), idx(un.owner_rows()),
                                  idx(un.pair_slots), un.n_slots)

    def _index(self, a) -> torch.Tensor:
        return self._tensor(a, torch.int64)

    def _set_layer(self, blocks: dict) -> None:
        """The layer tables from per-shard blocks (``hops_layer``, and
        ``outer_map`` as local point ids)."""
        un = self.union
        self.layer = {
            "hops_layer": self._index(un.rows(blocks["hops_layer"])),
            "outer_map": self._index(un.rows(blocks["outer_map"],
                                             ids=True))}

    def _set_boundary(self, blocks: dict, rep: dict,
                      distance_tolerance: float) -> None:
        """The boundary-smoothing tables from per-shard blocks (point
        maps as local point ids), the replicated target geometry and the
        scaled distance tolerance."""
        un = self.union
        host = {k: un.rows(blocks[k]) for k in (
            "is_corner", "is_feature_edge", "is_smoothing_surface",
            "is_connected", "smoothing_surface", "point_strings",
            "corner_targets", "feat_neigh_mask")}
        for k in ("inner_map", "feat_neigh"):
            host[k] = un.rows(blocks[k], ids=True)
        internal = un.topo.is_internal_point
        host.update({k: rep[k] for k in ("edge_a", "edge_b", "edge_strings",
                                         "tri_a", "tri_b", "tri_c")})
        host.update(distance_tolerance=distance_tolerance,
                    feat_rows=np.where(host["feat_neigh_mask"].any(1))[0],
                    surf_rows=np.where(
                        host["is_smoothing_surface"] & ~internal
                        & ~host["is_corner"] & ~host["is_feature_edge"])[0])
        self.bnd = self._bnd_tables(host)
        self.smoothing_surface = self.bnd["smoothing_surface"]

    @property
    def n_points(self) -> int:
        return self.mesh.n_points

    def _global_setup(self) -> MeshTopology:
        """The global topology for the one-time set-up (layer maps,
        boundary classification), compiled once; the boundary set-up
        frees it."""
        if self._global_topo is None:
            self._global_topo = compile_topology(self.mesh)
        return self._global_topo

    def _setup_maps(self) -> None:
        """Hop counts, prismatic maps and propagated normals on the
        global mesh (host), restricted to the shards."""
        if self.layer_maps is not None:
            return
        self._stage_normals_tables()
        topo = self._global_setup()
        bn, sharp = lay.boundary_point_normals_np(self.mesh.points, topo)
        self.layer_maps = lay.build_layer_maps(
            topo, bn, sharp,
            topo.patch_ids_matching(self.params.layer_patches),
            topo.patch_ids_matching(self.params.smoothing_patches),
            self.params.max_layers)
        normals = scatter.restrict_vectors(self.layer_maps.normals_init,
                                           self.shards.l2g,
                                           self.shards.n_padded_points)
        self.normals = self._tensor(self.union.rows(normals), self.dtype)

    def enable_boundary_smoothing(
        self, surf_vertices, surf_tris,
        init_edge_points, init_edges,
        target_edge_points=None, target_edges=None,
        checkpoint_corner=None, checkpoint_feature=None,
    ) -> BoundarySetup:
        """Boundary point smoothing on the shards: the classification
        runs once on the global mesh (host) and is restricted to each
        shard; a shared point's projections are its owner's.  Returns
        the classification in the global mesh's point order."""
        sh = self.shards
        if target_edge_points is None:
            target_edge_points, target_edges = init_edge_points, init_edges
        for pts, edges in ((init_edge_points, init_edges),
                           (target_edge_points, target_edges)):
            check_edge_mesh_sanity(pts, edges, self.stats.min_edge_length,
                                   self.stats.perimeter)
        self._setup_maps()
        topo = self._global_setup()
        setup = classify_boundary_points(
            topo, init_edge_points, init_edges,
            target_edge_points, target_edges, surf_vertices, surf_tris,
            topo.patch_ids_matching(self.params.layer_patches),
            topo.patch_ids_matching(self.params.smoothing_patches),
            self.mesh.points, self.params.distance_tolerance,
            checkpoint_corner=checkpoint_corner,
            checkpoint_feature=checkpoint_feature)
        self.boundary_setup = setup
        self._global_topo = None
        g2ls = scatter.g2l_maps(sh.l2g, self.mesh.n_points)
        blocks, rep, scalars = scatter.scatter_boundary_setup(
            setup, self.layer_maps, sh.l2g, g2ls, sh.topos,
            sh.n_padded_points, self.transform, self._scale)
        self._set_boundary(blocks, rep, scalars["distance_tolerance"])
        return setup

    # -- host-side assembly ---------------------------------------------------
    def shard_points(self) -> np.ndarray:
        """(D, Npad, 3) internal points of the shards held here, padded
        rows 0 (the JAX class's ``points``)."""
        sh, un = self.shards, self.union
        q = self.points.detach().to("cpu", torch.float64).numpy()
        out = np.zeros((len(un.shards), sh.n_padded_points, 3))
        for i in range(len(un.shards)):
            a, b = un.base[i, 0], un.base[i + 1, 0]
            out[i, :b - a] = q[a:b]
        return out

    def to_external_point_field(self, arr) -> np.ndarray:
        """A per-point array over the union rows -> the global mesh's
        point order, each point from its owner's row (over the ranks
        with ``distributed``)."""
        arr = np.asarray(arr)
        un = self.union
        if not self.distributed:
            sh = self.shards
            rows = un.base[sh.point_owner_shard, 0] + sh.point_owner_local
            return arr[rows]
        import torch.distributed as dist

        glob = torch.zeros((self.mesh.n_points,) + arr.shape[1:],
                           dtype=torch.float64)
        own = un.owned
        glob[torch.from_numpy(un.l2g[own])] = torch.from_numpy(
            np.asarray(arr[own], dtype=np.float64))
        dist.all_reduce(glob, op=dist.ReduceOp.SUM)
        return glob.numpy().astype(arr.dtype, copy=False)

    def quality(self) -> dict:
        """The global quality report, from the entities each shard
        claims (each face, edge and cell once, from a shard whose local
        closure of it is complete), with no global topology."""
        keys = (CUDA_QUALITY_TD_KEYS if self.device.type == "cuda"
                else QUALITY_TD_KEYS)
        missing = keys - set(self.td)
        if missing:
            from smoothmesh_torch.device import to_device

            self.td.update(to_device(self.topo, self.device, missing))
        un = self.union
        part = quality_report_parts(
            self.points, self.td,
            face_claim=self._tensor(un.claim_face, torch.bool),
            edge_claim=self._tensor(un.claim_edge, torch.bool),
            cell_claim=self._tensor(un.claim_cell, torch.bool))
        parts = [part]
        if self.distributed:
            import torch.distributed as dist

            parts = [None] * dist.get_world_size()
            dist.all_gather_object(parts, part)
        rep = combine_quality_parts(parts)
        s = self._scale
        for k in ("min_edge_length", "max_edge_length"):
            rep[k] /= s
        for k in ("min_volume", "max_volume", "total_volume",
                  "min_pyramid_volume"):
            rep[k] /= s ** 3
        return rep
