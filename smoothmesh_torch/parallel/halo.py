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

Here the shards run all on one device, as one union topology
(:class:`UnionSync`), or one shard a member of a group
(:class:`DistSync`): a rank over ``torch.distributed``, or a host
thread of this process a device (``devices=``,
:mod:`smoothmesh_torch.parallel.cards`);
:mod:`smoothmesh_torch.parallel.union` holds what this shares with the
disjoint decomposition.

The host part (:func:`build_halo_shards`) is numpy and builds the same
shards as the JAX package's, each compiled by this package's topology
compiler.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from smoothmesh_torch.io.polymesh import PolyMesh
from smoothmesh_torch.mesh.tiling import permute_mesh
from smoothmesh_torch.mesh.topology import (MeshTopology,
                                            boundary_point_mask,
                                            compile_topology)
from smoothmesh_torch.parallel.partition import (extract_submesh,
                                                 face_patch_ids,
                                                 partition_cells)
from smoothmesh_torch.parallel.sync import DistSync, UnionSync
from smoothmesh_torch.parallel.union import (UnionSmoother, _pad_rows,
                                             common_widths, pad_topology)
from smoothmesh_torch.parallel.union import union_topology  # noqa: F401
from smoothmesh_torch.quality import (combine_quality_parts,
                                      quality_report_parts, quality_td_keys)
from smoothmesh_torch.tracing import Trace

KB = 2048   # entity-count rounding of the padded shards (the JAX package's)


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
                      trace: Optional[Trace] = None) -> HaloShards:
    """The halo shards of ``mesh`` (the JAX package's
    ``build_halo_shards``, same arrays): each shard's submesh spatially
    reordered and compiled, padded to common entity counts (multiples
    of :data:`KB`) and widths, with the shared-point routing, the
    quality claims and the edge-length extremes.  ``is_internal_point``
    comes from the global mesh: a shard's own compile sees its
    ``procBoundary`` faces as boundary.  ``trace``: receives the
    topology compiles as ``setup.compiles`` spans."""
    if cell_shard is None:
        cell_shard = partition_cells(mesh, n_shards)
    D = n_shards
    N, C, F = mesh.n_points, mesh.n_cells, mesh.n_faces
    Fi = mesh.n_internal_faces
    global_internal = ~boundary_point_mask(mesh)

    face_patch = face_patch_ids(mesh)

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
    trace = Trace() if trace is None else trace

    for d in range(D):
        lmesh, gids, _cells = extract_submesh(mesh, local[d], face_patch)
        pmesh, orders = permute_mesh(lmesh)
        with trace.span("setup.compiles"):
            topo = compile_topology(pmesh)
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

    n_pts = _round_kb(max(t.n_points for t in topos_raw))
    n_cls = _round_kb(max(t.n_cells for t in topos_raw))
    n_fcs = _round_kb(max(t.n_faces for t in topos_raw))
    n_edg = _round_kb(max(t.n_edges for t in topos_raw))
    widths = common_widths(topos_raw)
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
# The smoother
# ---------------------------------------------------------------------------

class HaloSmoother(UnionSmoother):
    """Smoothing on the halo decomposition into ``n_shards`` shards.

    The counterpart of the JAX package's ``HaloSmoother``
    (``smoothmesh_tpu/parallel/halo.py:569``; ``n_shards`` stands for
    its ``n_devices``, ``devices=`` is its ``devices``), with the
    driver's features: the default constraints with the face angle,
    layer blending and boundary smoothing.  It is the single-device
    smoother on the union of the shards
    (:class:`~smoothmesh_torch.parallel.union.UnionSmoother`) with the
    halo exchanges and the owner mask passed into the iteration: all
    shards on ``device`` together
    (:class:`~smoothmesh_torch.parallel.sync.UnionSync`), or the shard
    of this member of a group, with ``distributed`` or ``devices=``
    (:class:`~smoothmesh_torch.parallel.sync.DistSync`).
    """

    @staticmethod
    def _shards_of(mesh: PolyMesh, n_shards: int,
                   trace: Trace) -> HaloShards:
        return build_halo_shards(mesh, n_shards, trace=trace)

    def _set_exchange(self) -> None:
        un, idx = self.union, self._index
        self.owned = self._tensor(un.owned, torch.bool)
        if self.group is not None:
            self.sync = DistSync(idx(un.pair_rows), idx(un.pair_slots),
                                 self._tensor(un.pair_owner, torch.bool),
                                 un.n_slots, self.group)
        else:
            self.sync = UnionSync(idx(un.pair_rows), idx(un.owner_rows()),
                                  idx(un.pair_slots), un.n_slots)

    def quality(self) -> dict:
        """The global quality report, from the entities each shard
        claims (each face, edge and cell once, from a shard whose local
        closure of it is complete), with no global topology."""
        missing = quality_td_keys(self.device, self.dtype) - set(self.td)
        if missing:
            from smoothmesh_torch.device import to_device

            self.td.update(to_device(self.topo, self.device, missing))
        un = self.union
        part = quality_report_parts(
            self.points, self.td,
            face_claim=self._tensor(un.claim_face, torch.bool),
            edge_claim=self._tensor(un.claim_edge, torch.bool),
            cell_claim=self._tensor(un.claim_cell, torch.bool))
        parts = ([part] if self.group is None
                 else self.group.all_gather_object(part))
        return self._external_units(combine_quality_parts(parts))
