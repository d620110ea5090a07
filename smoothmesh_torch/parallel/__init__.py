"""Multi-shard smoothing: the halo (overlap) domain decomposition.

  - ``partition`` recursive coordinate bisection of the cells
  - ``halo``      the halo shards (host), their union topology and
                  :class:`~smoothmesh_torch.parallel.halo.HaloSmoother`
  - ``scatter``   the global layer and boundary set-up restricted to
                  each shard
  - ``sync``      the cross-shard exchanges: all shards on one device
                  (``UnionSync``) or one shard a rank over
                  ``torch.distributed`` (``DistSync``)
  - ``ranks``     starting the ranks of a ``DistSync`` run
"""
