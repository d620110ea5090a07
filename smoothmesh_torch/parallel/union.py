"""The shards of a domain decomposition side by side, and their smoother.

Both decompositions of :mod:`smoothmesh_torch.parallel` (the halo,
:mod:`~smoothmesh_torch.parallel.halo`, and the disjoint one,
:mod:`~smoothmesh_torch.parallel.sharded`) run the single-device
iteration (``driver.iteration_body``) on every shard and add their
cross-shard exchanges (:mod:`smoothmesh_torch.parallel.sync`).  Here
the shards run in one of three ways:

  - all on one device: the shards' tables are concatenated into one
    *union* topology (:func:`union_topology`), every entity id offset
    by its shard's base, so each kernel launches once an iteration over
    all the shards together, and the batched driver's CUDA graph
    carries the iteration with its exchanges;
  - one shard a member of a group, the union of the member's shard
    alone on the member's device: a rank over ``torch.distributed``
    (``sync.ProcessGroup``; on the rank's own card under NCCL,
    ``parallel.ranks.join``, on the CPU or a shared card under gloo),
    or a host thread of this process, one a device
    (``parallel.cards``: ``devices=``).

:class:`UnionSmoother` is the single-device ``Smoother`` on such a
union, with the set-up the two decompositions share: the global layer
and boundary set-up restricted to the shards, and the assembly of the
global mesh.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from smoothmesh_torch import layers as lay
from smoothmesh_torch.boundary import BoundarySetup, check_edge_mesh_sanity
from smoothmesh_torch.boundary import classify_boundary_points
from smoothmesh_torch.device import resolve_device
from smoothmesh_torch.driver import Smoother
from smoothmesh_torch.io.polymesh import PolyMesh
from smoothmesh_torch.mesh.topology import MeshTopology, compile_topology
from smoothmesh_torch.params import SmoothingParams
from smoothmesh_torch.parallel import scatter
from smoothmesh_torch.parallel.sync import ProcessGroup
from smoothmesh_torch.quality import MeshStats

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


def common_widths(topos) -> Dict[str, int]:
    """The widest of each width group (``pad_topology``'s ``widths``)
    over ``topos``."""
    return {g: max(getattr(t, f).shape[1] for t in topos)
            for f, g in WIDTH_GROUPS.items()}


# ---------------------------------------------------------------------------
# The union topology: the shards side by side
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardUnion:
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
    owned: np.ndarray             # (U,) bool: the row is its point's owner's
    l2g: np.ndarray               # (U,) global point of each union row
    # the halo's quality claims (None for the disjoint decomposition)
    claim_face: Optional[np.ndarray]
    claim_edge: Optional[np.ndarray]
    claim_cell: Optional[np.ndarray]
    # the shared points held here: each (point, holder) pair's union
    # row, its shared-point index, whether the holder owns it, and the
    # holder's shard
    pair_rows: np.ndarray
    pair_slots: np.ndarray
    pair_owner: np.ndarray
    pair_shard: np.ndarray
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


def union_topology(sh, shards: Optional[Sequence[int]] = None) -> ShardUnion:
    """The union of ``shards`` (default all) of ``sh`` (a ``HaloShards``
    or a ``ShardedMesh``): the live rows of each shard's topology,
    padded to the widths common to all the shards, entity ids offset."""
    shards = tuple(range(sh.n_shards) if shards is None else shards)
    n_local = sh.n_local[list(shards)]
    base = np.zeros((len(shards) + 1, 4), dtype=np.int64)
    np.cumsum(n_local, axis=0, out=base[1:])
    col = {e: i for i, e in enumerate(ENTITIES)}
    widths = common_widths(sh.topos)
    t0 = sh.topos[shards[0]]
    kw = {}
    for f in dataclasses.fields(MeshTopology):
        if f.name not in ROW_ENTITY:
            continue
        parts = []
        for i, d in enumerate(shards):
            a = getattr(sh.topos[d], f.name)[:n_local[i, col[ROW_ENTITY[
                f.name]]]]
            if f.name in WIDTH_GROUPS:
                a = _pad_cols(a, widths[WIDTH_GROUPS[f.name]],
                              False if a.dtype == np.bool_ else 0)
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
        if blocks is None:
            return None
        return np.concatenate([blocks[d][:n_local[i, col[entity]]]
                               for i, d in enumerate(shards)])

    rows, slots, owner, shard = [], [], [], []
    for i, d in enumerate(shards):
        s = np.where(sh.shared_valid[d])[0]
        rows.append(sh.shared_slot_local[d, s] + base[i, 0])
        slots.append(s)
        owner.append(sh.shared_owner_is_me[d, s])
        shard.append(np.full(len(s), d, dtype=np.int64))
    return ShardUnion(
        shards=shards, topo=topo, base=base,
        points=cat(sh.local_points, "point"),
        owned=cat(sh.owned, "point"),
        l2g=np.concatenate([sh.l2g[d] for d in shards]),
        claim_face=cat(getattr(sh, "claim_face", None), "face"),
        claim_edge=cat(getattr(sh, "claim_edge", None), "edge"),
        claim_cell=cat(getattr(sh, "claim_cell", None), "cell"),
        pair_rows=np.concatenate(rows), pair_slots=np.concatenate(slots),
        pair_owner=np.concatenate(owner), pair_shard=np.concatenate(shard),
        n_slots=sh.shared_valid.shape[1])


# ---------------------------------------------------------------------------
# The smoother
# ---------------------------------------------------------------------------

def _rank_device(device: torch.device) -> torch.device:
    """The device of this rank's shard, under the initialized default
    process group: ``device`` under gloo; under NCCL the rank's card
    (the current device), which ``device`` must name or leave open."""
    import torch.distributed as dist

    backend = dist.get_backend()
    if backend == "gloo":
        return device
    if backend != "nccl":
        raise ValueError(f"the shards' ranks run on nccl or gloo, not "
                         f"{backend}")
    card = torch.device("cuda", torch.cuda.current_device())
    if device.type != "cuda" or device.index not in (None, card.index):
        raise ValueError(f"an NCCL rank's shard runs on its card, {card}, "
                         f"not on {device}")
    return card


class UnionSmoother(Smoother):
    """The single-device :class:`Smoother` on the union of a
    decomposition's shards, with its exchanges (``sync``), so
    :meth:`steps` (CUDA graph replays on the card, one host read a
    batch), :meth:`step`, :meth:`run` and the face-angle rerun are the
    driver's.  A subclass builds the shards (:meth:`_shards_of`) and the
    exchange (:meth:`_set_exchange`).

    ``device``: ``"cuda"`` by default (raises without a card); ``"cpu"``
    runs the plain versions.  All shards run on it together, unless
    the shards run one a member of a group (eagerly: the exchanges are
    collectives, which the batched driver does not capture):

      - ``distributed``: ``torch.distributed`` must be initialized
        (NCCL or gloo), ``n_shards`` is its world size, and this
        process runs the shard of its rank on ``device``.  Under NCCL
        that is the rank's card, the current device
        (``parallel.ranks.join`` makes it so): ``"cuda"`` resolves to
        it, and another card raises ``ValueError``;
      - ``devices=[...]`` (keyword; the JAX classes' ``devices``): one
        shard on each device, in this process, one host thread a
        device; more than one device returns a
        :class:`~smoothmesh_torch.parallel.cards.CardSmoother` with
        this class's surface (a device listed twice holds two shards,
        each on its own stream), one device is the one member of a
        group of one, in the caller's thread;
      - ``group``: the member of a group this smoother is (what the
        two above pass: a ``sync.ProcessGroup``, or a
        ``parallel.cards.Member``, whose device it runs on).  A card
        group's members build the shards, the layer maps and the
        boundary classification once, for all of them.

    ``points`` is the union's (U, 3) internal points, the shards' rows
    one after another (``union.base``); :meth:`shard_points` gives the
    JAX classes' (D, Npad, 3) blocks and :meth:`denormalize` the global
    mesh in its own point order, each point from its owner's row.
    ``setup_times``: the seconds of the shard build (of which the
    topology compiles), the union and the upload.
    """

    def __new__(cls, *args, devices=None, **kw):
        if devices is not None and len(devices) > 1:
            from smoothmesh_torch.parallel.cards import CardSmoother

            return CardSmoother(cls, devices, *args, **kw)
        return super().__new__(cls)

    def __init__(self, mesh: PolyMesh, params: SmoothingParams,
                 n_shards: Optional[int] = None, dtype=None,
                 normalize: bool = True, device=None,
                 distributed: bool = False, *, devices=None, group=None):
        if devices is not None:
            if device is not None or distributed or group is not None \
                    or n_shards not in (None, 1):
                raise ValueError("devices= places the shards: give no "
                                 "device=, distributed=, group= or other "
                                 "n_shards")
            from smoothmesh_torch.parallel.cards import CardGroup

            group = CardGroup([resolve_device(devices[0])]).members[0]
        elif distributed:
            if group is not None:
                raise ValueError("distributed= is the process group: "
                                 "give no group=")
            group = ProcessGroup()
        if group is None:
            device = resolve_device(device)
        elif isinstance(group, ProcessGroup):
            device = _rank_device(resolve_device(device))
        elif device is not None:
            raise ValueError("a card-group member runs on its device: "
                             "give no device=")
        else:
            device = group.device
        self.group = group
        self._build(mesh, n_shards)
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
            self._set_layer(self._once("layer blocks", lambda: (
                scatter.scatter_layer_maps(
                    self.layer_maps, sh.l2g,
                    scatter.g2l_maps(sh.l2g, mesh.n_points),
                    sh.n_padded_points)[0])))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.setup_times["upload"] += time.perf_counter() - self._t_upload

    @staticmethod
    def _shards_of(mesh: PolyMesh, n_shards: int, times: dict):
        """The decomposition's host build of ``mesh`` into ``n_shards``
        shards (with ``n_local``, ``topos``, ``l2g``, ``owned``, the
        shared-point tables, the owner maps and the edge-length
        extremes); ``times`` receives the seconds of its compiles."""
        raise NotImplementedError

    def _set_exchange(self) -> None:
        """The exchange of ``self.union`` on ``self.device``: ``sync``
        (and the halo's ``owned``)."""
        raise NotImplementedError

    def _once(self, key, fn):
        """``fn()``, once for the members of this smoother's card group
        (each computes its own otherwise)."""
        return fn() if self.group is None else self.group.once(key, fn)

    def _build(self, mesh: PolyMesh, n_shards: Optional[int]) -> None:
        """The host part: the shards, their union and the mesh stats."""
        times = {}
        if self.group is not None:
            rank, world = self.group.rank, self.group.world
            if n_shards not in (None, world):
                raise ValueError(f"n_shards {n_shards} != world size "
                                 f"{world}")
            n_shards, which = world, [rank]
        else:
            n_shards = 1 if n_shards is None else int(n_shards)
            which = None
        t0 = time.perf_counter()

        def build():
            built = {}
            return self._shards_of(mesh, n_shards, built), built

        sh, built = self._once("shards", build)
        times.update(built)
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
        self._global_topo = None
        self.setup_times = times

    def _start(self, points, params, center, scale, device,
               dtype) -> None:
        """The device state of the union from its internal points and
        the resolved parameters, with the exchange."""
        self._t_upload = time.perf_counter()
        self.setup_times["upload"] = 0.0
        self._setup(self.union.topo, points, params, center, scale, device,
                    dtype, orders=None)
        self._set_exchange()

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
        boundary classification), compiled once (once for a card
        group's members); the boundary set-up frees it."""
        if self._global_topo is None:
            self._global_topo = self._once(
                "global topology", lambda: compile_topology(self.mesh))
        return self._global_topo

    def _setup_maps(self) -> None:
        """Hop counts, prismatic maps and propagated normals on the
        global mesh (host), restricted to the shards."""
        if self.layer_maps is not None:
            return
        self._stage_normals_tables()

        def host():
            topo = self._global_setup()
            bn, sharp = lay.boundary_point_normals_np(self.mesh.points, topo)
            maps = lay.build_layer_maps(
                topo, bn, sharp,
                topo.patch_ids_matching(self.params.layer_patches),
                topo.patch_ids_matching(self.params.smoothing_patches),
                self.params.max_layers)
            return maps, scatter.restrict_vectors(
                maps.normals_init, self.shards.l2g,
                self.shards.n_padded_points)

        self.layer_maps, normals = self._once("layer maps", host)
        self.normals = self._tensor(self.union.rows(normals), self.dtype)

    def enable_boundary_smoothing(
        self, surf_vertices, surf_tris,
        init_edge_points, init_edges,
        target_edge_points=None, target_edges=None,
        checkpoint_corner=None, checkpoint_feature=None,
    ) -> BoundarySetup:
        """Boundary point smoothing on the shards: the classification
        runs once on the global mesh (host) and is restricted to each
        shard, the feature points' neighbours taken from each shard's
        own topology (``scatter.scatter_boundary_setup``); a shared
        point's sums go through the exchange.  Returns the
        classification in the global mesh's point order."""
        sh = self.shards
        if target_edge_points is None:
            target_edge_points, target_edges = init_edge_points, init_edges
        for pts, edges in ((init_edge_points, init_edges),
                           (target_edge_points, target_edges)):
            check_edge_mesh_sanity(pts, edges, self.stats.min_edge_length,
                                   self.stats.perimeter)
        self._setup_maps()

        def host():
            topo = self._global_setup()
            setup = classify_boundary_points(
                topo, init_edge_points, init_edges,
                target_edge_points, target_edges, surf_vertices, surf_tris,
                topo.patch_ids_matching(self.params.layer_patches),
                topo.patch_ids_matching(self.params.smoothing_patches),
                self.mesh.points, self.params.distance_tolerance,
                checkpoint_corner=checkpoint_corner,
                checkpoint_feature=checkpoint_feature)
            g2ls = scatter.g2l_maps(sh.l2g, self.mesh.n_points)
            return setup, scatter.scatter_boundary_setup(
                setup, self.layer_maps, sh.l2g, g2ls, sh.topos,
                sh.n_padded_points, self.transform, self._scale)

        setup, (blocks, rep, scalars) = self._once("boundary", host)
        self.boundary_setup = setup
        self._global_topo = None
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
        point order, each point from its owner's row (over a group's
        members: each writes its owned points into a float64 field of
        zeros on its device, one all-reduce SUM adds each point's one
        value to zeros, exactly, and the sum is copied to the host
        once)."""
        arr = np.asarray(arr)
        un = self.union
        if self.group is None:
            sh = self.shards
            rows = un.base[sh.point_owner_shard, 0] + sh.point_owner_local
            return arr[rows]
        glob = torch.zeros((self.mesh.n_points,) + arr.shape[1:],
                           dtype=torch.float64, device=self.device)
        own = un.owned
        glob[self._index(un.l2g[own])] = self._tensor(arr[own],
                                                      torch.float64)
        self.group.all_reduce(glob, "SUM")
        return glob.cpu().numpy().astype(arr.dtype, copy=False)

    def _external_units(self, rep: dict) -> dict:
        """A quality report of internal coordinates in external units."""
        s = self._scale
        for k in ("min_edge_length", "max_edge_length"):
            rep[k] /= s
        for k in ("min_volume", "max_volume", "total_volume",
                  "min_pyramid_volume"):
            rep[k] /= s ** 3
        return rep
