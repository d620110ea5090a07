"""The halo decomposition's cross-shard exchanges.

Every shard holds the complete 1-ring of the points it owns
(:mod:`smoothmesh_torch.parallel.halo`), so the single-device iteration
runs unchanged on each shard and only these exchanges are added
(``driver.iteration_body(..., sync=, owned=)``), as the JAX package's
``HaloDenseSync`` (``smoothmesh_tpu/parallel/sync.py:212-263``) and
``PlanarSync`` (``smoothmesh_tpu/parallel/halo.py:456-505``) make them:

  - ``consensus(field)``: every holder of a shared point takes the
    owner's value (the owner's stencil is complete, so its value is the
    global one);
  - ``or_(mask)``: the OR of a shared point's holders (reference orEqOp,
    src/smoothMesh.C:2374-2380);
  - ``all_max(x)``, ``all_sum(x)``: the scalar all-reduces (reference
    returnReduce, :1567, :2396);
  - ``sum``, ``min_mag_sqr``: the disjoint decomposition's partial-sum
    and closest-candidate combines (the normals' and projections' sums,
    the neighbour coordinates), which under the halo reduce to
    ``consensus``.

Two implementations, and neither falls back to the other:

  - :class:`UnionSync`: all shards in one process on one device.  Their
    tables are concatenated into one union topology, so each exchange
    is a static index operation on the union, and the scalar
    all-reduces are the plain reductions the iteration already makes
    over it.  Nothing reads the host, so the batched driver captures
    the halo iteration into its CUDA graph as it does the single-device
    one.
  - :class:`DistSync`: one shard a rank over ``torch.distributed``
    (gloo); each exchange is one ``all_reduce`` on an (S, ...) buffer of
    the S shared points.

Both write the owner's value plus +0.0 (the JAX ``psum`` of the owner's
value with the other shards' zeros), so a -0.0 arrives as +0.0 on every
holder, the owner too, and the two agree bit for bit.
"""

from __future__ import annotations

import torch


class UnionSync:
    """The exchanges on the union topology of all shards (one device).

    ``rows``: (P,) the union row of each (shared point, holder) pair;
    ``owner_rows``: (P,) the owner's union row of the pair's point;
    ``slots``: (P,) the pair's shared-point index in [0, S).
    """

    #: no step reads the host: CUDA graphs may capture it
    capturable = True

    def __init__(self, rows, owner_rows, slots, n_slots: int):
        self.rows = rows
        self.owner_rows = owner_rows
        self.slots = slots
        self.n_slots = int(n_slots)

    def consensus(self, field):
        v = field.index_select(0, self.owner_rows)
        if v.is_floating_point():
            v = v + 0.0
        return field.index_copy(0, self.rows, v)

    def or_(self, mask):
        acc = torch.zeros(self.n_slots, dtype=torch.int32,
                          device=mask.device)
        acc.index_add_(0, self.slots,
                       mask.index_select(0, self.rows).to(torch.int32))
        return mask.index_copy(0, self.rows,
                               (acc > 0).index_select(0, self.slots))

    def all_max(self, x):
        return x

    def all_sum(self, x):
        return x

    sum = min_mag_sqr = consensus


class DistSync:
    """The exchanges of one shard a rank over ``torch.distributed``.

    ``rows``: (K,) this shard's local rows that hold a shared point;
    ``slots``: (K,) their shared-point index in [0, S); ``owner``: (K,)
    bool, this shard owns the point.

    Runs eagerly: every exchange is a collective the host waits for, so
    the batched driver does not capture it into a CUDA graph.  It runs
    on the default process group, whose backend must be gloo: gloo
    reduces CUDA tensors through the host, so the ranks may share one
    card.  NCCL is not supported: the halo smoother maps no rank to a
    card of its own and gathers the global points on the host.
    """

    capturable = False

    def __init__(self, rows, slots, owner, n_slots: int):
        self.rows = rows
        self.slots = slots
        self.owner = owner
        self.n_slots = int(n_slots)

    def _all_reduce(self, buf, op):
        import torch.distributed as dist

        dist.all_reduce(buf, op=op)
        return buf

    def consensus(self, field):
        import torch.distributed as dist

        dtype = field.dtype
        src = field if dtype != torch.bool else field.to(torch.int32)
        v = src.index_select(0, self.rows)
        own = self.owner.view((-1,) + (1,) * (v.dim() - 1))
        buf = src.new_zeros((self.n_slots,) + tuple(src.shape[1:]))
        buf.index_copy_(0, self.slots, torch.where(own, v, 0))
        buf = self._all_reduce(buf, dist.ReduceOp.SUM)
        out = src.index_copy(0, self.rows, buf.index_select(0, self.slots))
        return out.to(dtype)

    def or_(self, mask):
        import torch.distributed as dist

        buf = torch.zeros(self.n_slots, dtype=torch.int32,
                          device=mask.device)
        buf.index_copy_(0, self.slots,
                        mask.index_select(0, self.rows).to(torch.int32))
        buf = self._all_reduce(buf, dist.ReduceOp.MAX)
        return mask.index_copy(0, self.rows,
                               (buf > 0).index_select(0, self.slots))

    def all_max(self, x):
        import torch.distributed as dist

        return self._all_reduce(x.reshape(1).clone(),
                                dist.ReduceOp.MAX).reshape(())

    def all_sum(self, x):
        import torch.distributed as dist

        return self._all_reduce(x.reshape(1).clone(),
                                dist.ReduceOp.SUM).reshape(())

    sum = min_mag_sqr = consensus
