"""DistSync (one halo shard a rank over torch.distributed, gloo, two
ranks in processes of their own started by
smoothmesh_torch.parallel.ranks) against UnionSync (both shards in this
process): the union rows of each rank's points, the residuals, the
frozen and ray-miss counts and the denormalized mesh bit-equal after
the run, with the default constraints (face angle on) and with
boundary smoothing (tc7), and the quality report assembled from both
ranks' claims.  Each rank imports only torch and
smoothmesh_torch and meets the other through a FileStore in tmp_path.
"""

import dataclasses

import numpy as np
import pytest
import torch

from smoothmesh_torch import testcases as ttc
from smoothmesh_torch.mesh.blockmesh import hex_block, perturb
from smoothmesh_torch.parallel.halo import HaloSmoother
from smoothmesh_torch.parallel.ranks import Job, run_ranks
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
def test_dist_sync_matches_union_sync(name, tmp_path):
    mesh, params, geometry = _case(name)
    ranks = run_ranks(Job(mesh, params, ITERS, device="cpu", dtype="float64",
                          geometry=geometry), WORLD, tmp_path)
    hs = HaloSmoother(mesh, params, n_shards=WORLD, device="cpu",
                      dtype=torch.float64)
    if geometry is not None:
        hs.enable_boundary_smoothing(*geometry)
    want = [dataclasses.astuple(r) for r in hs.steps(ITERS)]
    assert len(want) == ITERS
    base = hs.union.base[:, 0]
    for rank, out in enumerate(ranks):
        # (iteration, residual, n_frozen, wall_ms, n_ray_miss)
        assert [r[:3] + r[4:] for r in out["results"]] == \
            [r[:3] + r[4:] for r in want]
        assert torch.equal(out["points"],
                           hs.points[base[rank]:base[rank + 1]])
        np.testing.assert_array_equal(out["denormalized"], hs.denormalize())
        # the report from both ranks' claims (its sums in another order)
        for k, v in hs.quality().items():
            assert out["quality"][k] == pytest.approx(v, rel=1e-12), k
    moved = np.abs(hs.denormalize() - mesh.points).max()
    assert moved > 1e-3
