"""The disjoint domain decomposition's smoother.

The counterpart of the JAX package's ``ShardedSmoother``
(``smoothmesh_tpu/parallel/sharded.py``), its analog of the reference's
``mpirun -np N smoothMesh -parallel``: every cell lives on one shard
(:func:`~smoothmesh_torch.parallel.partition.build_shards`), each shard
computes its partial results, and the points on the cuts combine them
with the reference's sync sites (:mod:`smoothmesh_torch.parallel.sync`,
:class:`~smoothmesh_torch.parallel.sync.UnionPointSync` and
:class:`~smoothmesh_torch.parallel.sync.DistPointSync`).  The freezes
are each shard's own decisions, OR-combined, as the reference's ranks
make them, so they may differ from one shard's near the cuts.
"""

from __future__ import annotations

import torch

from smoothmesh_torch.device import to_device
from smoothmesh_torch.io.polymesh import PolyMesh
from smoothmesh_torch.mesh.topology import compile_topology
from smoothmesh_torch.parallel.partition import ShardedMesh, build_shards
from smoothmesh_torch.parallel.sync import DistPointSync, UnionPointSync
from smoothmesh_torch.parallel.union import UnionSmoother
from smoothmesh_torch.quality import quality_report, quality_td_keys
from smoothmesh_torch.tracing import Trace


class ShardedSmoother(UnionSmoother):
    """Smoothing on the disjoint decomposition into ``n_shards`` shards
    (``n_shards`` stands for the JAX class's ``n_devices``).

    The single-device smoother on the union of the shards
    (:class:`~smoothmesh_torch.parallel.union.UnionSmoother`: the
    arguments, ``device``, ``distributed`` and ``devices=`` (the JAX
    class's ``devices``), the points' layout and ``setup_times`` are
    described there), with the disjoint exchanges
    and no owner mask, so each kernel launches once an iteration over
    all the shards (K3 too, whose shared rows are then recomputed with
    the exchanges).  The shards are built from the mesh as given, in
    its own point order (no spatial reorder), as the JAX class builds
    them.  A shared point's owner is the lowest shard that holds it:
    :meth:`denormalize` takes each point from there.
    """

    #: the global topology's tables of the quality report, staged at
    #: its first call
    _report_td = None

    @staticmethod
    def _shards_of(mesh: PolyMesh, n_shards: int,
                   trace: Trace) -> ShardedMesh:
        return build_shards(mesh, n_shards, trace=trace)

    def _set_exchange(self) -> None:
        un, idx = self.union, self._index
        owner = self._tensor(un.pair_owner, torch.bool)
        if self.group is not None:
            self.sync = DistPointSync(idx(un.pair_rows), idx(un.pair_slots),
                                      owner, un.n_slots, self.group)
        else:
            self.sync = UnionPointSync(idx(un.pair_rows),
                                       idx(un.pair_slots),
                                       idx(un.pair_shard), owner,
                                       self.shards.n_shards, un.n_slots)

    def quality(self) -> dict:
        """The checkMesh-style report of the global mesh at the
        assembled points (as the JAX class gives it), with length- and
        volume-valued metrics in external units, on the global topology,
        compiled and staged at the first call.  In a group every member
        assembles the points; a member that does not report (a card
        group's but rank 0) returns None."""
        q = self.points.detach().to("cpu", torch.float64).numpy()
        ext = self.to_external_point_field(q)
        if self.group is not None and not self.group.reports:
            return None
        if self._report_td is None:
            self._report_td = to_device(
                compile_topology(self.mesh), self.device,
                quality_td_keys(self.device, self.dtype))
        pts = self._tensor(ext, self.dtype)
        return self._external_units(quality_report(pts, self._report_td))

