"""What the card's K3 (the predictor) and K8 (the ray cast) rely on,
checked on the CPU:

- the rows of ``point_cells`` and ``point_points`` are left-packed
  (mask == arange(W) < count) in every topology the tests run (the
  14x12x10 hex, the 8x8x6 prism, tc1-tc8);
- K3 runs the share-a-cell test only where the blend fraction is
  positive: the port's plain predictor chain with the test run so
  equals the JAX XLA predictor in float64 and the chain that runs it
  everywhere bit for bit, on meshes where the test bites;
- K8's launch geometry covers every (ray, triangle) pair exactly once
  and passes the checks of its C entry point.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smoothmesh_tpu import geometry as jgeo
from smoothmesh_tpu.device import to_device as jax_to_device
from smoothmesh_tpu.mesh.blockmesh import hex_block as jhex_block
from smoothmesh_tpu.mesh.blockmesh import perturb as jperturb
from smoothmesh_tpu.mesh.blockmesh import prism_block as jprism_block
from smoothmesh_tpu.mesh.tiling import permute_mesh as jpermute_mesh
from smoothmesh_tpu.mesh.topology import compile_topology as jcompile
from smoothmesh_tpu.ops import smoothing as jsm
from smoothmesh_torch import geometry as geo
from smoothmesh_torch import testcases as tcs
from smoothmesh_torch.device import to_device
from smoothmesh_torch.mesh.blockmesh import hex_block, perturb, prism_block
from smoothmesh_torch.mesh.tiling import permute_mesh
from smoothmesh_torch.mesh.topology import MeshTopology, compile_topology
from smoothmesh_torch.ops import raycast
from smoothmesh_torch.ops import smoothing as sm

torch.set_num_threads(1)

#: the blocks of tests/test_torch_smoothing.py, and the bench's graded,
#: perturbed hex at 12^3
BLOCKS = ("hex", "prism", "graded")
RSF = 0.5
MAX_STEP = 0.013
_TOPO_FIELDS = [f.name for f in dataclasses.fields(MeshTopology)]


def _block(kind, jax_builders=False):
    """One of :data:`BLOCKS`, built by the port's generators or the JAX
    package's."""
    hexb, pert, prism = ((jhex_block, jperturb, jprism_block) if jax_builders
                         else (hex_block, perturb, prism_block))
    if kind == "hex":
        return pert(hexb(n=(14, 12, 10)), amplitude=0.05, seed=5)
    if kind == "graded":
        base = hexb(n=(12, 12, 12), grading=(2.0, 1.0, 0.5))
        spacing = min(np.diff(np.unique(base.points[:, a])).min()
                      for a in range(3))
        return pert(base, amplitude=0.25 * spacing, seed=3)
    return pert(prism(n=(8, 8, 6)), amplitude=0.04, seed=6)


def _mesh(kind):
    return _block(kind) if kind in BLOCKS else tcs.ALL[kind]().mesh


@pytest.mark.parametrize("kind", [*BLOCKS, *tcs.ALL])
def test_rows_are_left_packed(kind):
    mesh, _ = permute_mesh(_mesh(kind))
    td = to_device(compile_topology(mesh), "cpu")
    for table in ("point_cells", "point_points"):
        mask = td[f"{table}_mask"]
        count = mask.sum(1)
        slots = torch.arange(mask.shape[1])[None, :]
        assert torch.equal(mask, slots < count[:, None]), table
        assert int(count.max()) >= 1


@functools.lru_cache(maxsize=None)
def _setup(kind):
    jm, _ = jpermute_mesh(_block(kind, jax_builders=True))
    jtopo = jcompile(jm)
    topo = MeshTopology(**{k: getattr(jtopo, k) for k in _TOPO_FIELDS})
    return jm, jax_to_device(jtopo), to_device(topo, "cpu")


@jax.jit
def _jax_predictor(pts, jtd):
    """The JAX XLA predictor chain (boundary points fixed)."""
    cc = jgeo.cell_centres(pts, jtd)
    cent = jsm.centroidal_smoothing(pts, cc, jtd, False)
    prop = jsm.aspect_ratio_smoothing(pts, cent, jtd)
    return jsm.constrain_max_step_length(pts, prop, MAX_STEP, RSF)


def _port_predictor(pts, td, lazy_share):
    """The port's plain predictor chain; ``lazy_share``: with the share
    test run only where the blend fraction is positive, in K3's order."""
    cc = geo.cell_centres(pts, td)
    cent = sm.centroidal_smoothing(pts, cc, td, False)
    if lazy_share:
        frac, c1, c2, i1, i2 = sm._blend_fraction(pts, td)
        rows = sm.share_test_mask(pts, td).nonzero()[:, 0]
        has_common = torch.zeros_like(frac, dtype=torch.bool)
        has_common[rows] = sm._share_cell(td, i1[rows], i2[rows])
        prop = sm._blend(pts, cent, torch.where(has_common, 0.0, frac),
                         c1, c2)
    else:
        prop = sm.aspect_ratio_smoothing(pts, cent, td)
    return sm.constrain_max_step_length(pts, prop, MAX_STEP, RSF)


@pytest.mark.parametrize("kind", BLOCKS)
def test_lazy_share_test_matches_jax(kind):
    jm, jtd, td = _setup(kind)
    pts = torch.from_numpy(np.asarray(jm.points, np.float64))
    want = np.asarray(_jax_predictor(jnp.asarray(jm.points, jnp.float64),
                                     jtd))
    got = _port_predictor(pts, td, lazy_share=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    assert torch.equal(got, _port_predictor(pts, td, lazy_share=False))

    # not vacuous: the share test zeroes a positive fraction somewhere
    frac, _, _, i1, i2 = sm._blend_fraction(pts, td)
    bites = (frac > 0) & sm._share_cell(td, i1, i2)
    assert int(bites.sum()) > 0
    # K3's test runs only where the fraction is positive, and wherever
    # it bites
    ran = sm.share_test_mask(pts, td)
    assert not (ran & ~(frac > 0)).any() and not (bites & ~ran).any()


#: (rays, triangles): none, one ray, a triangle count that is not a
#: multiple of the tile or of the slices, the 128^3 boundary cell's
#: first iteration (16,129 x 7,938) and the 32^3 check's rays
GEOMETRY_CASES = [(0, 7938), (16129, 0), (0, 0), (1, 7938), (1, 1),
                  (16129, 7937), (16129, 7938), (961, 7938), (5000, 1000)]


@pytest.mark.parametrize("n_rays,n_tri", GEOMETRY_CASES)
@pytest.mark.parametrize("n_sm", [132, 1])
def test_k8_launch_geometry_covers_each_pair_once(n_rays, n_tri, n_sm):
    g = raycast.launch_geometry(n_rays, n_tri, n_sm)
    per_block = raycast.THREADS * raycast.RAYS_PER_THREAD
    # block x casts rays x * per_block + k * THREADS + thread (k < R)
    rays = (np.arange(g.ray_blocks)[:, None, None] * per_block
            + np.arange(raycast.RAYS_PER_THREAD)[None, :, None]
            * raycast.THREADS
            + np.arange(raycast.THREADS)[None, None, :]).ravel()
    ray_hits = np.bincount(rays[rays < n_rays], minlength=n_rays)
    assert (ray_hits == 1).all()
    assert g.ray_blocks == 0 or (g.ray_blocks - 1) * per_block < n_rays
    if n_rays == 0:
        assert g.ray_blocks == 0
        return
    if n_tri == 0:                         # only the fill: no slice
        assert g.slices == 0
        return
    # slice y tests triangles [y * tps, min(n_tri, (y + 1) * tps))
    tps = g.tris_per_slice
    assert tps > 0 and tps % raycast.TILE == 0
    assert 0 < g.slices <= 65535
    tris = np.concatenate([np.arange(y * tps, min(n_tri, (y + 1) * tps))
                           for y in range(g.slices)])
    assert (np.bincount(tris, minlength=n_tri) == 1).all()
    assert (g.slices - 1) * tps < n_tri      # no slice without triangles
    # the grid aims at BLOCKS_PER_SM blocks an SM where the tiles allow
    tiles = -(-n_tri // raycast.TILE)
    want = raycast.BLOCKS_PER_SM * n_sm
    if tiles * g.ray_blocks >= want:
        assert g.ray_blocks * g.slices >= want // 2
    else:
        assert g.slices == tiles


def test_k8_plain_edge_cases():
    """What the card holds K8 to at its edges: no triangles -> +inf, no
    rays -> empty, an origin on a triangle -> a zero hit on the side of
    the direction's sign."""
    soup = torch.tensor(raycast.pack_triangles(
        [[0.0, 0.0, 0.0]], [[1.0, 0.0, 0.0]], [[0.0, 1.0, 0.0]]))
    o = torch.tensor([[0.25, 0.25, 0.0], [0.25, 0.25, 0.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]])
    tp, tn = raycast.segment_triangle_hits(o, d, 2.0, soup)
    assert torch.equal(tp, torch.zeros(2)) and torch.isinf(tn).all()
    tp, tn = raycast.segment_triangle_hits(o, d, 2.0, soup[:, :0])
    assert torch.isinf(tp).all() and torch.isinf(tn).all()
    tp, tn = raycast.segment_triangle_hits(o[:0], d[:0], 2.0, soup)
    assert tp.shape == tn.shape == (0,)
