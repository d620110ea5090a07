"""The cross-shard exchanges of the two domain decompositions.

The halo decomposition (:class:`UnionSync`, :class:`DistSync`) first,
then the disjoint one (:class:`UnionPointSync`, :class:`DistPointSync`,
below).

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
    (NCCL, one card a rank, or gloo); each exchange is one
    ``all_reduce`` on an (S, ...) buffer of the S shared points, on the
    field's device.

Both write the owner's value plus +0.0 (the JAX ``psum`` of the owner's
value with the other shards' zeros), so a -0.0 arrives as +0.0 on every
holder, the owner too, and the two agree bit for bit.
"""

from __future__ import annotations

import torch


def _all_reduce(buf, op: str):
    """``buf`` all-reduced in place over the default process group with
    ``torch.distributed.ReduceOp`` ``op`` -> ``buf``."""
    import torch.distributed as dist

    dist.all_reduce(buf, op=getattr(dist.ReduceOp, op))
    return buf


def _all_reduce_scalar(x, op: str):
    return _all_reduce(x.reshape(1).clone(), op).reshape(())


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

    Runs on the default process group, NCCL (each rank on its own card,
    the buffers never leave it) or gloo (on the CPU, or ranks sharing
    a card: gloo reduces CUDA tensors through the host).  Eager: the
    batched driver does not capture its collectives into a CUDA graph
    (under NCCL they are asynchronous on the stream, so the host does
    not wait for them).  With no shared point (S = 0, as at world 1)
    no exchange reduces anything, on either backend.
    """

    capturable = False

    def __init__(self, rows, slots, owner, n_slots: int):
        self.rows = rows
        self.slots = slots
        self.owner = owner
        self.n_slots = int(n_slots)

    def consensus(self, field):
        dtype = field.dtype
        src = field if dtype != torch.bool else field.to(torch.int32)
        v = src.index_select(0, self.rows)
        own = self.owner.view((-1,) + (1,) * (v.dim() - 1))
        buf = src.new_zeros((self.n_slots,) + tuple(src.shape[1:]))
        buf.index_copy_(0, self.slots, torch.where(own, v, 0))
        if self.n_slots:
            _all_reduce(buf, "SUM")
        out = src.index_copy(0, self.rows, buf.index_select(0, self.slots))
        return out.to(dtype)

    def or_(self, mask):
        buf = torch.zeros(self.n_slots, dtype=torch.int32,
                          device=mask.device)
        buf.index_copy_(0, self.slots,
                        mask.index_select(0, self.rows).to(torch.int32))
        if self.n_slots:
            _all_reduce(buf, "MAX")
        return mask.index_copy(0, self.rows,
                               (buf > 0).index_select(0, self.slots))

    def all_max(self, x):
        return _all_reduce_scalar(x, "MAX")

    def all_sum(self, x):
        return _all_reduce_scalar(x, "SUM")

    sum = min_mag_sqr = consensus


# ---------------------------------------------------------------------------
# The disjoint decomposition (parallel.sharded)
# ---------------------------------------------------------------------------

def _vsmall(dtype) -> float:
    """OpenFOAM VSMALL (smoothMeshCommon.H) as the JAX package's
    ``PointSync`` takes it: the smallest positive normal of the
    coordinate type, roughly."""
    return 1e-37 if dtype == torch.float32 else 1e-300


def _big(dtype) -> float:
    """The null of ``min_mag_sqr`` (the JAX package's, per dtype)."""
    return 1e18 if dtype == torch.float32 else 1e150


def _mag_sqr(v):
    return v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]


def is_smaller_by_vector_elements(v1, v2):
    """Element-wise lexicographic vector compare (reference
    ``isSmallerByVectorElements``, src/smoothMesh.C:222-239): true where
    the first differing component of ``v1`` is the smaller.  Inputs
    (..., 3); returns (...) bool."""
    x1, y1, z1 = v1[..., 0], v1[..., 1], v1[..., 2]
    x2, y2, z2 = v2[..., 0], v2[..., 1], v2[..., 2]
    return (x1 < x2) | ((x1 == x2) & ((y1 < y2)
                                      | ((y1 == y2) & (z1 < z2))))


def is_closer_point(p1, p2):
    """Reference ``isCloserPoint`` (src/smoothMesh.C:246-272), literal:
    p1 is closer than p2 where they differ and mag(p1) - mag(p2) <
    VSMALL, or the magnitudes tie within VSMALL and p1 is element-wise
    the smaller."""
    eq = (p1 == p2).all(-1)
    d = torch.sqrt(_mag_sqr(p1)) - torch.sqrt(_mag_sqr(p2))
    vs = _vsmall(p1.dtype)
    return ~eq & ((d < vs) | ((d.abs() < vs)
                              & is_smaller_by_vector_elements(p1, p2)))


def _fold_sum(acc, c):
    return acc + c


def _fold_or(acc, c):
    return acc | c


def _fold_min_mag_sqr(acc, c):
    m2c, m2a = _mag_sqr(c), _mag_sqr(acc)
    take = (m2c < m2a) | ((m2c == m2a) & is_smaller_by_vector_elements(c, acc))
    return torch.where(take[:, None], c, acc)


def _fold_max_mag_sqr(acc, c):
    return torch.where((_mag_sqr(c) > _mag_sqr(acc))[:, None], c, acc)


class _PointSync:
    """The disjoint decomposition's exchanges (the JAX package's
    ``PointSync``, ``smoothmesh_tpu/parallel/sync.py:60-209``).

    Each shard computes partial results over its own cells; a point on a
    cut is held by several shards (its *holders*), and these combine the
    holders' values with the (op, null) pairs of the reference's
    ``syncTools::syncPointList``.  Every combine reads, for each shared
    point, the candidates of all D shards (a holder's value, the null
    where a shard does not hold the point) and folds them in shard
    order from shard 0, so every holder computes the same bits.  Sums
    fold the same way.  ``all_*`` are the scalar all-reduces
    (reference ``returnReduce``).

    The ``pair_*`` forms take and return the values of this shard's
    (shared point, holder) rows, ``rows``, in that order; the field
    forms take and return whole (N, ...) fields, whose other rows pass
    through.  A subclass gives the candidates (:meth:`_candidates`) and
    the scalar reductions.
    """

    def __init__(self, rows, slots, owner, n_shards: int, n_slots: int):
        self.rows = rows
        self.slots = slots
        self.owner = owner
        self.n_shards = int(n_shards)
        self.n_slots = int(n_slots)

    def _candidates(self, v, null):
        """(D, S, ...) the holders' values of each shared point, ``null``
        where a shard does not hold it, floating values plus +0.0."""
        raise NotImplementedError

    def _combine(self, v, null, fold):
        allv = self._candidates(v, null)
        acc = allv[0]
        for d in range(1, self.n_shards):
            acc = fold(acc, allv[d])
        return acc.index_select(0, self.slots)

    # -- the pair forms ------------------------------------------------------
    def pair_sum(self, v):
        """plusEqOp (vector or scalar/label sums), null 0."""
        return self._combine(v, 0, _fold_sum)

    def pair_or(self, v):
        """orEqOp<bool>, null false."""
        return self._combine(v, False, _fold_or)

    def pair_max(self, v, null):
        """maxEqOp, null ``null``."""
        return self._combine(v, null, torch.maximum)

    def pair_min_mag_sqr(self, v):
        """minMagSqrEqOp<vector>: the smaller magnitude squared wins, an
        exact tie goes to the element-wise smaller (the coordinate
        tie-break of ``isSmallerByVectorElements``, which makes every
        holder agree on symmetric meshes)."""
        return self._combine(v, _big(v.dtype), _fold_min_mag_sqr)

    def pair_max_mag_sqr(self, v):
        """maxMagSqrEqOp<vector>, null 0."""
        return self._combine(v, 0, _fold_max_mag_sqr)

    def pair_consensus(self, v):
        """Every holder takes the owner's value (plus +0.0).  Not a
        reference sync site: it pins a shared point to its owner's
        proposal, so the holders stay bit-identical."""
        own = self.owner.view((-1,) + (1,) * (v.dim() - 1))
        return self.pair_sum(torch.where(own, v, torch.zeros_like(v)))

    def pair_closest_points(self, c1, c2, c3, has_common):
        """The three-position global merge of findClosestPoints
        (reference src/smoothMesh.C:389-479), per holder: per position,
        the min-magnitude candidate over the holders; where it is
        closer than the holder's own (``isCloserPoint``), the holder's
        chain shifts down and its shared-cell flag clears.  The flag is
        then OR-combined (:472-478)."""
        g1 = self.pair_min_mag_sqr(c1)
        take = is_closer_point(g1, c1)
        t = take[:, None]
        c3 = torch.where(t, c2, c3)
        c2 = torch.where(t, c1, c2)
        c1 = torch.where(t, g1, c1)
        has_common = has_common & ~take
        g2 = self.pair_min_mag_sqr(c2)
        take = is_closer_point(g2, c2)
        t = take[:, None]
        c3 = torch.where(t, c2, c3)
        c2 = torch.where(t, g2, c2)
        has_common = has_common & ~take
        g3 = self.pair_min_mag_sqr(c3)
        c3 = torch.where(is_closer_point(g3, c3)[:, None], g3, c3)
        return c1, c2, c3, self.pair_or(has_common)

    # -- the field forms -----------------------------------------------------
    def _field(self, pair_op, field, *args):
        return field.index_copy(
            0, self.rows, pair_op(field.index_select(0, self.rows), *args))

    def sum(self, field):
        return self._field(self.pair_sum, field)

    def or_(self, field):
        return self._field(self.pair_or, field)

    def max(self, field, null):
        return self._field(self.pair_max, field, null)

    def min_mag_sqr(self, field):
        return self._field(self.pair_min_mag_sqr, field)

    def max_mag_sqr(self, field):
        return self._field(self.pair_max_mag_sqr, field)

    def consensus(self, field):
        return self._field(self.pair_consensus, field)

    def closest_points(self, c1, c2, c3, has_common):
        r = self.rows
        out = self.pair_closest_points(
            *(x.index_select(0, r) for x in (c1, c2, c3, has_common)))
        return tuple(x.index_copy(0, r, o)
                     for x, o in zip((c1, c2, c3, has_common), out))


class UnionPointSync(_PointSync):
    """The disjoint exchanges on the union topology of all shards (one
    device).

    ``rows``: (P,) the union row of each (shared point, holder) pair;
    ``slots``: (P,) its shared-point index in [0, S); ``shards``: (P,)
    its holder's shard; ``owner``: (P,) the holder owns the point.  A
    static (D, S) table holds each shared point's pair on each shard,
    P (a null row) where the shard does not hold it.  No step reads the
    host, so the batched driver's CUDA graph captures the iteration;
    the scalar all-reduces are the plain reductions the iteration
    already makes over the union.
    """

    capturable = True

    def __init__(self, rows, slots, shards, owner, n_shards: int,
                 n_slots: int):
        super().__init__(rows, slots, owner, n_shards, n_slots)
        n = rows.numel()
        table = torch.full((self.n_shards, self.n_slots), n,
                           dtype=torch.int64, device=rows.device)
        table[shards, slots] = torch.arange(n, device=rows.device)
        self.table = table

    def _candidates(self, v, null):
        if v.is_floating_point():
            v = v + 0.0
        ext = torch.cat([v, v.new_full((1,) + tuple(v.shape[1:]), null)])
        return ext[self.table]

    def all_max(self, x):
        return x

    def all_min(self, x):
        return x

    def all_sum(self, x):
        return x


class DistPointSync(_PointSync):
    """The disjoint exchanges of one shard a rank over
    ``torch.distributed`` (NCCL or gloo, as :class:`DistSync`).

    ``rows``, ``slots``, ``owner``: as :class:`UnionPointSync`'s, for
    this rank's shard ``rank``.  Each rank writes its own row of a
    (D, S, ...) buffer of zeros (its values, the null where it does not
    hold a point) and one ``all_reduce`` SUM gives every rank every row
    exactly (a -0.0 arrives as +0.0, as the union writes it); the fold
    then runs locally.  Eager: the batched driver does not capture it.
    """

    capturable = False

    def __init__(self, rows, slots, owner, rank: int, n_shards: int,
                 n_slots: int):
        super().__init__(rows, slots, owner, n_shards, n_slots)
        self.rank = int(rank)

    def _candidates(self, v, null):
        dtype = v.dtype
        src = v.to(torch.int32) if dtype == torch.bool else v
        buf = src.new_zeros((self.n_shards, self.n_slots)
                            + tuple(src.shape[1:]))
        buf[self.rank] = int(null) if dtype == torch.bool else null
        buf[self.rank].index_copy_(0, self.slots, src)
        if self.n_slots:
            _all_reduce(buf, "SUM")
        return buf.to(dtype)

    def all_max(self, x):
        return _all_reduce_scalar(x, "MAX")

    def all_min(self, x):
        return _all_reduce_scalar(x, "MIN")

    def all_sum(self, x):
        return _all_reduce_scalar(x, "SUM")
