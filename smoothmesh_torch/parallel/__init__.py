"""Multi-shard smoothing: the two domain decompositions.

  - ``partition`` recursive coordinate bisection of the cells, submesh
                  extraction and the disjoint shards (``build_shards``)
  - ``halo``      the halo (overlap) shards and
                  :class:`~smoothmesh_torch.parallel.halo.HaloSmoother`
  - ``sharded``   the disjoint decomposition's
                  :class:`~smoothmesh_torch.parallel.sharded.ShardedSmoother`
                  (the reference's ``mpirun -np N smoothMesh -parallel``)
  - ``union``     the shards of either side by side as one topology, and
                  the smoother both run on it
  - ``scatter``   the global layer and boundary set-up restricted to
                  each shard
  - ``sync``      the cross-shard exchanges, all shards on one device
                  (``UnionSync``, ``UnionPointSync``) or one shard a
                  member of a group (``DistSync``, ``DistPointSync``):
                  a rank over ``torch.distributed`` (``ProcessGroup``)
                  or a device of this process (``cards``)
  - ``ranks``     starting the ranks of a distributed run
  - ``cards``     one shard a device in this process, one host thread a
                  device (``devices=``): ``CardGroup`` and
                  ``CardSmoother``
"""
