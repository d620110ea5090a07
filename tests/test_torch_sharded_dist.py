"""DistPointSync (one disjoint shard a rank over torch.distributed,
gloo, two ranks in processes of their own started by
smoothmesh_torch.parallel.ranks) against UnionPointSync (both shards in
this process): the union rows of each rank's points, the residuals, the
frozen and ray-miss counts, the denormalized mesh and the quality
report bit-equal after the run, with the default constraints at a band
that bites (60/120, face angle on) and with boundary smoothing (tc7).
Each rank imports only torch and smoothmesh_torch and meets the other
through a FileStore in tmp_path.
"""

import dataclasses

import numpy as np
import pytest
import torch

from smoothmesh_torch import testcases as ttc
from smoothmesh_torch.mesh.blockmesh import hex_block, perturb
from smoothmesh_torch.parallel.ranks import Job, run_ranks
from smoothmesh_torch.parallel.sharded import ShardedSmoother
from smoothmesh_torch.params import SmoothingParams

torch.set_num_threads(1)

ITERS = 6
WORLD = 2


def _case(name):
    """(mesh, params, boundary geometry or None)."""
    if name == "default":
        mesh = perturb(hex_block(n=(8, 6, 6)), amplitude=0.06, seed=7)
        return mesh, SmoothingParams(centroidal_iters=ITERS, rel_tol=0.0,
                                     min_angle=60.0, max_angle=120.0), None
    tc = ttc.ALL[name]()
    return tc.mesh, dataclasses.replace(
        tc.params, centroidal_iters=ITERS, rel_tol=0.0,
        max_step_length=0.25), tc.geometry


@pytest.mark.parametrize("name", ["default", "tc7"])
def test_dist_point_sync_matches_union(name, tmp_path):
    mesh, params, geometry = _case(name)
    ranks = run_ranks(Job(mesh, params, ITERS, device="cpu", dtype="float64",
                          geometry=geometry, decomposition="disjoint"),
                      WORLD, tmp_path)
    ss = ShardedSmoother(mesh, params, n_shards=WORLD, device="cpu",
                         dtype=torch.float64)
    if geometry is not None:
        ss.enable_boundary_smoothing(*geometry)
    want = [dataclasses.astuple(r) for r in ss.steps(ITERS)]
    assert len(want) == ITERS
    base = ss.union.base[:, 0]
    quality = ss.quality()
    for rank, out in enumerate(ranks):
        # (iteration, residual, n_frozen, wall_ms, n_ray_miss)
        assert [r[:3] + r[4:] for r in out["results"]] == \
            [r[:3] + r[4:] for r in want]
        assert torch.equal(out["points"],
                           ss.points[base[rank]:base[rank + 1]])
        np.testing.assert_array_equal(out["denormalized"], ss.denormalize())
        assert out["quality"] == quality
    assert np.abs(ss.denormalize() - mesh.points).max() > 1e-3
