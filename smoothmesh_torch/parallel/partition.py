"""Mesh partitioner and the disjoint decomposition's shards (numpy,
host side).

The reference relies on OpenFOAM's offline ``decomposePar`` (scotch) to
split the mesh into per-rank partitions with processor patches; here
it is done in-process, as the JAX package's
``smoothmesh_tpu.parallel.partition`` does it (same results):

  1. :func:`partition_cells`: recursive coordinate bisection of rough
     cell centroids into ``n_shards`` balanced cell sets;
  2. :func:`build_shards`: per shard, the local PolyMesh of its cells
     (:func:`extract_submesh`), whose faces to other shards become a
     ``procBoundary`` patch of type ``processor``, compiled by this
     package's topology compiler; and the shared-point tables of the
     exchanges (:mod:`smoothmesh_torch.parallel.sync`).

Each cell lives on exactly one shard; a point on a cut is held by
every shard with one of its cells, and the shards combine their
partial results for it with the (op, null) pairs of the reference's
``syncTools::syncPointList``.  ``is_internal_point`` comes from the
global mesh: a shard's own compile sees its ``procBoundary`` faces as
boundary.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from smoothmesh_torch.io.polymesh import Patch, PolyMesh
from smoothmesh_torch.mesh.topology import (MeshTopology,
                                            boundary_point_mask,
                                            compile_topology)
from smoothmesh_torch.tracing import Trace


def cell_centroids_rough(mesh: PolyMesh) -> np.ndarray:
    """Cheap cell centroids (mean of face-point means) for partitioning."""
    flat = mesh.face_flat
    offs = mesh.face_offsets
    counts = np.diff(offs)
    face_of = np.repeat(np.arange(mesh.n_faces), counts)
    fsum = np.zeros((mesh.n_faces, 3))
    np.add.at(fsum, face_of, mesh.points[flat])
    fmean = fsum / counts[:, None]

    C = mesh.n_cells
    acc = np.zeros((C, 3))
    n = np.zeros(C)
    np.add.at(acc, mesh.owner, fmean)
    np.add.at(n, mesh.owner, 1)
    ni = mesh.neighbour
    np.add.at(acc, ni, fmean[: len(ni)])
    np.add.at(n, ni, 1)
    return acc / n[:, None]


def partition_cells(mesh: PolyMesh, n_shards: int) -> np.ndarray:
    """Recursive coordinate bisection -> (C,) shard ids, balanced."""
    ctr = cell_centroids_rough(mesh)
    C = mesh.n_cells
    shard = np.zeros(C, dtype=np.int64)

    def split(idx: np.ndarray, base: int, k: int) -> None:
        if k <= 1:
            shard[idx] = base
            return
        k1 = k // 2
        axis = int(np.argmax(ctr[idx].max(0) - ctr[idx].min(0)))
        order = np.argsort(ctr[idx, axis], kind="stable")
        n1 = (len(idx) * k1) // k
        split(idx[order[:n1]], base, k1)
        split(idx[order[n1:]], base + k1, k - k1)

    split(np.arange(C), 0, n_shards)
    return shard


def face_patch_ids(mesh: PolyMesh) -> np.ndarray:
    """(F,) the patch of each face, -1 for internal faces."""
    face_patch = np.full(mesh.n_faces, -1, dtype=np.int64)
    for pid, p in enumerate(mesh.patches):
        face_patch[p.start_face: p.start_face + p.n_faces] = pid
    return face_patch


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
# The disjoint decomposition's shards
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardedMesh:
    """The disjoint shards of a mesh (the JAX package's ``ShardedMesh``
    less its ``stacked`` padded tables, which only ``shard_map`` needs).

    ``shared_slot_local``: (D, S) the local row of each shared point on
    each shard, ``n_padded_points`` (Npad, the largest local point
    count) where the shard does not hold it; ``shared_valid``: (D, S)
    it does; ``shared_owner_is_me``: (D, S) the shard is the point's
    owner, the lowest shard that holds it.
    """

    n_shards: int
    topos: List[MeshTopology]           # per-shard local topology
    local_points: np.ndarray            # (D, Npad, 3) initial coordinates
    n_local_points: np.ndarray          # (D,)
    local_to_global: List[np.ndarray]   # per shard: local -> global point
    shared_slot_local: np.ndarray       # (D, S)
    shared_valid: np.ndarray            # (D, S) bool
    shared_owner_is_me: np.ndarray      # (D, S) bool
    point_owner_shard: np.ndarray       # (Nglobal,) owning shard
    point_owner_local: np.ndarray       # (Nglobal,) local idx on owner
    # the global edge-length extremes (every local edge is a global one)
    min_edge_length: float = 0.0
    max_edge_length: float = 0.0

    @property
    def n_padded_points(self) -> int:
        return self.local_points.shape[1]

    @property
    def l2g(self) -> List[np.ndarray]:
        return self.local_to_global

    @property
    def n_local(self) -> np.ndarray:
        """(D, 4) each shard's points, cells, faces and edges."""
        return np.array([[t.n_points, t.n_cells, t.n_faces, t.n_edges]
                         for t in self.topos], dtype=np.int64)

    @property
    def owned(self) -> np.ndarray:
        """(D, Npad) the local row is its point's owner's copy."""
        out = np.zeros(self.local_points.shape[:2], dtype=bool)
        for d, g in enumerate(self.local_to_global):
            out[d, :len(g)] = self.point_owner_shard[g] == d
        return out

    def gather_global_points(self, local_points) -> np.ndarray:
        """Assemble the global point field from per-shard blocks."""
        lp = np.asarray(local_points)
        return lp[self.point_owner_shard, self.point_owner_local]


def build_shards(mesh: PolyMesh, n_shards: int,
                 cell_shard: Optional[np.ndarray] = None,
                 trace: Optional[Trace] = None) -> ShardedMesh:
    """The disjoint shards of ``mesh`` (the JAX package's
    ``build_shards``, the same arrays): each shard's cells as a local
    mesh in the global point order, compiled (native), with
    ``is_internal_point`` from the global mesh, and the shared-point
    routing.  ``trace``: receives the topology compiles as
    ``setup.compiles`` spans."""
    if cell_shard is None:
        cell_shard = partition_cells(mesh, n_shards)
    global_internal = ~boundary_point_mask(mesh)
    face_patch = face_patch_ids(mesh)

    topos: List[MeshTopology] = []
    l2g: List[np.ndarray] = []
    min_edge, max_edge = np.inf, 0.0
    trace = Trace() if trace is None else trace
    for d in range(n_shards):
        lmesh, gids, _cells = extract_submesh(mesh, cell_shard == d,
                                              face_patch)
        lmesh.validate()
        with trace.span("setup.compiles"):
            topo = compile_topology(lmesh)
        topo.is_internal_point = global_internal[gids]
        elen = np.linalg.norm(lmesh.points[topo.edges[:, 0]]
                              - lmesh.points[topo.edges[:, 1]], axis=1)
        min_edge = min(min_edge, float(elen.min()))
        max_edge = max(max_edge, float(elen.max()))
        topos.append(topo)
        l2g.append(gids)

    count = np.zeros(mesh.n_points, dtype=np.int64)
    for gids in l2g:
        count[gids] += 1
    shared_gids = np.where(count > 1)[0]
    S = len(shared_gids)

    npad = max(t.n_points for t in topos)
    pts = np.zeros((n_shards, npad, 3))
    slot_local = np.full((n_shards, S), npad, dtype=np.int64)
    valid = np.zeros((n_shards, S), dtype=bool)
    for d, gids in enumerate(l2g):
        pts[d, :len(gids)] = mesh.points[gids]
        g2l = np.full(mesh.n_points, -1, dtype=np.int64)
        g2l[gids] = np.arange(len(gids))
        li = g2l[shared_gids]
        has = li >= 0
        slot_local[d, has] = li[has]
        valid[d] = has

    owner_shard = np.full(mesh.n_points, -1, dtype=np.int64)
    owner_local = np.full(mesh.n_points, -1, dtype=np.int64)
    for d in reversed(range(n_shards)):
        owner_shard[l2g[d]] = d
        owner_local[l2g[d]] = np.arange(len(l2g[d]))
    if np.any(owner_shard < 0):
        raise ValueError("unassigned global points after sharding")

    return ShardedMesh(
        n_shards=n_shards, topos=topos, local_points=pts,
        n_local_points=np.array([len(g) for g in l2g], dtype=np.int64),
        local_to_global=l2g, shared_slot_local=slot_local,
        shared_valid=valid,
        shared_owner_is_me=(owner_shard[shared_gids][None, :]
                            == np.arange(n_shards)[:, None]),
        point_owner_shard=owner_shard, point_owner_local=owner_local,
        min_edge_length=min_edge, max_edge_length=max_edge)
