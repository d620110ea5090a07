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


class ShardedSmoother(UnionSmoother):
    """Smoothing on the disjoint decomposition into ``n_shards`` shards
    (``n_shards`` stands for the JAX class's ``n_devices``).

    The single-device smoother on the union of the shards
    (:class:`~smoothmesh_torch.parallel.union.UnionSmoother`: the
    arguments, ``device`` and ``distributed``, the points' layout and
    ``setup_times`` are described there), with the disjoint exchanges
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

    def _shards_of(self, mesh: PolyMesh, n_shards: int,
                   times: dict) -> ShardedMesh:
        return build_shards(mesh, n_shards, times=times)

    def _set_exchange(self) -> None:
        un, idx = self.union, self._index
        owner = self._tensor(un.pair_owner, torch.bool)
        D = self.shards.n_shards
        if self.distributed:
            self.sync = DistPointSync(idx(un.pair_rows), idx(un.pair_slots),
                                      owner, un.shards[0], D, un.n_slots)
        else:
            self.sync = UnionPointSync(idx(un.pair_rows),
                                       idx(un.pair_slots),
                                       idx(un.pair_shard), owner, D,
                                       un.n_slots)

    def quality(self) -> dict:
        """The checkMesh-style report of the global mesh at the
        assembled points (as the JAX class gives it), with length- and
        volume-valued metrics in external units, on the global topology,
        compiled and staged at the first call."""
        if self._report_td is None:
            self._report_td = to_device(
                compile_topology(self.mesh), self.device,
                quality_td_keys(self.device, self.dtype))
        q = self.points.detach().to("cpu", torch.float64).numpy()
        pts = self._tensor(self.to_external_point_field(q), self.dtype)
        return self._external_units(quality_report(pts, self._report_td))

