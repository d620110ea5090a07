"""The port's boundary point smoothing (``smoothmesh_torch.boundary``)
and ray cast (``smoothmesh_torch.ops.raycast``) against the JAX
package's, on the meshes and target geometry of the testcases tc5 and
tc7:

- the host builders (edge strings, the batched closest-edge query, the
  classification) array-equal;
- the per-iteration functions (feature-edge projections, surface
  centroids, the priority projection with its ray cast) to 1e-12 in
  float64, on the same point order and inputs made from a seed;
- the plain version behind K8 against the JAX XLA ray cast in float64
  (to 1e-12, the same hits and misses) and against the Pallas kernel in
  interpret mode in float32 on the soup of tests/test_boundary.py
  (rtol 1e-4, atol 1e-6, the same hits and misses).
"""

import dataclasses
import functools
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from smoothmesh_tpu import boundary as jbps
from smoothmesh_tpu import layers as jlay
from smoothmesh_tpu import testcases as jtc
from smoothmesh_tpu.device import to_device as jax_to_device
from smoothmesh_tpu.mesh.topology import compile_topology as jax_compile
from smoothmesh_tpu.ops.raycast import pack_triangles as jax_pack
from smoothmesh_tpu.ops.raycast import segment_triangle_hits_pallas
from smoothmesh_tpu.quality import mesh_stats
from smoothmesh_torch import boundary as bps
from smoothmesh_torch import testcases as ttc
from smoothmesh_torch.device import to_device
from smoothmesh_torch.geometry import face_centres_areas
from smoothmesh_torch.mesh.topology import compile_topology
from smoothmesh_torch.ops import raycast

CASES = ["tc5", "tc7"]
TOL = 1e-12
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_jax_hits = jax.jit(jbps.segment_triangle_hits)


def _setup_args(case, topo):
    """classify_boundary_points' arguments for a testcase."""
    V, T, ip, ie, tp, te = case.geometry
    p = case.params.resolve(mesh_stats(case.mesh.points,
                                       topo.edges).min_edge_length)
    return (topo, ip, ie, tp, te, V, T,
            topo.patch_ids_matching(p.layer_patches),
            topo.patch_ids_matching(p.smoothing_patches), case.mesh.points,
            p.distance_tolerance)


def _tables(setup, topo):
    """The boundary tables in mesh coordinates (numpy), as the drivers
    build them, with unpadded compaction rows."""
    te = setup.target_edges
    return dict(
        is_corner=setup.is_corner, is_feature_edge=setup.is_feature_edge,
        is_smoothing_surface=setup.is_smoothing_surface,
        corner_targets=setup.corner_targets,
        point_strings=setup.point_strings, feat_neigh=setup.feat_neigh,
        feat_neigh_mask=setup.feat_neigh_mask,
        edge_a=setup.target_edge_points[te[:, 0]],
        edge_b=setup.target_edge_points[te[:, 1]],
        edge_strings=setup.target_edge_strings,
        tri_a=setup.surf_tri_a, tri_b=setup.surf_tri_b,
        tri_c=setup.surf_tri_c,
        feat_rows=np.where(setup.feat_neigh_mask.any(axis=1))[0],
        surf_rows=np.where(setup.is_smoothing_surface
                           & ~topo.is_internal_point & ~setup.is_corner
                           & ~setup.is_feature_edge)[0],
        distance_tolerance=setup.distance_tolerance)


def _jax_tables(host, n):
    """The JAX driver's form: jnp arrays, rows padded with N."""
    out = {k: (v if np.isscalar(v) else jnp.asarray(v))
           for k, v in host.items()}
    for k in ("feat_rows", "surf_rows"):
        r = host[k]
        out[k] = jnp.asarray(np.concatenate(
            [r, np.full((-len(r)) % 128 or 128, n)]).astype(np.int32))
    out["n_tri"] = len(host["tri_a"])
    return out


def _torch_tables(host, topo):
    """The port driver's form: tensors, the soup packed (float64), and
    the rows of the smoothing-surface boundary points."""
    out = {k: (v if np.isscalar(v) else torch.tensor(v))
           for k, v in host.items() if not k.startswith("tri_")}
    out["tri_packed"] = torch.tensor(raycast.pack_triangles(
        host["tri_a"], host["tri_b"], host["tri_c"], np.float64))
    out["smooth_rows"] = torch.tensor(np.where(
        host["is_smoothing_surface"] & ~topo.is_internal_point)[0])
    return out


def _face_centres(pts, td):
    return face_centres_areas(torch.tensor(pts), td["face_points"],
                              td["face_mask"], td["face_npoints"]).centres


@functools.lru_cache(maxsize=None)
def _case(name):
    """JAX and port topologies, device topologies, classifications and
    boundary tables of a testcase (the same point order on both
    sides)."""
    jt, tt = jtc.ALL[name](), ttc.ALL[name]()
    jtopo, ttopo = jax_compile(jt.mesh), compile_topology(tt.mesh)
    want = jbps.classify_boundary_points(*_setup_args(jt, jtopo))
    got = bps.classify_boundary_points(*_setup_args(tt, ttopo))
    host = _tables(got, ttopo)
    return dict(jtopo=jtopo, ttopo=ttopo, jtd=jax_to_device(jtopo),
                ttd=to_device(ttopo, "cpu"), want=want, got=got,
                pts=tt.mesh.points, geometry=tt.geometry,
                jbd=_jax_tables(host, ttopo.n_points),
                tbd=_torch_tables(host, ttopo))


@pytest.mark.parametrize("name", ["tc4", "tc5", "tc7"])
def test_testcases_match(name):
    jt, tt = jtc.ALL[name](), ttc.ALL[name]()
    for f in ("points", "face_flat", "face_offsets", "owner", "neighbour"):
        np.testing.assert_array_equal(getattr(tt.mesh, f),
                                      getattr(jt.mesh, f))
    assert [dataclasses.astuple(p) for p in tt.mesh.patches] == \
        [dataclasses.astuple(p) for p in jt.mesh.patches]
    assert dataclasses.asdict(tt.params) == dataclasses.asdict(jt.params)
    for g, w in zip(tt.geometry, jt.geometry):
        np.testing.assert_array_equal(g, w)


def test_bench_dome_matches():
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(REPO, "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    want = bench._dome_geometry()
    got = ttc.bench_dome_geometry()
    for g, w in zip(got[1:], want):
        np.testing.assert_array_equal(g, w)
    assert len(got[2]) == 7938 and len(got[4]) == 128
    np.testing.assert_array_equal(got[0](0.5, 0.5), 1.1)


@pytest.mark.parametrize("name", CASES)
def test_host_builders_match(name):
    c = _case(name)
    V, T, ip, ie, tp, te = c["geometry"]
    np.testing.assert_array_equal(bps.find_edge_strings(tp, te),
                                  jbps.find_edge_strings(tp, te))
    np.testing.assert_array_equal(bps.classifying_patch(c["ttopo"]),
                                  jbps.classifying_patch(c["jtopo"]))
    tol = c["got"].distance_tolerance
    for pair_budget in (4_000_000, 1000):        # one chunk, and many
        for g, w in zip(
                bps.closest_edge_batch(c["pts"], ip, ie, tol, pair_budget),
                jbps.closest_edge_batch(c["pts"], ip, ie, tol, pair_budget)):
            np.testing.assert_array_equal(g, w)
    strings = bps.find_edge_strings(tp, te)
    for pt in c["pts"][::37]:
        for required in (-1, 1):
            got = bps.find_closest_edge_info(pt, tp, te, strings, required,
                                             tol)
            want = jbps.find_closest_edge_info(pt, tp, te, strings,
                                               required, tol)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    for f in dataclasses.fields(c["want"]):
        g, w = getattr(c["got"], f.name), getattr(c["want"], f.name)
        np.testing.assert_array_equal(g, w, err_msg=f.name)
    # not vacuous: corners, feature points and free surface points
    got = c["got"]
    assert got.is_corner.sum() >= 4 and got.is_feature_edge.sum() > 0
    assert len(c["tbd"]["surf_rows"]) > 0
    # the sanity check passes and fails alike
    stats = mesh_stats(c["pts"], c["ttopo"].edges)
    bps.check_edge_mesh_sanity(ip, ie, stats.min_edge_length,
                               stats.perimeter)
    for mod in (bps, jbps):
        with pytest.raises(ValueError, match="Perimeter"):
            mod.check_edge_mesh_sanity(ip * 3.0, ie, stats.min_edge_length,
                                       stats.perimeter)


@pytest.mark.parametrize("name", CASES)
def test_feature_edge_projections_and_centroids_match(name):
    c = _case(name)
    rng = np.random.default_rng(3)
    pts = c["pts"] + 0.01 * rng.normal(size=c["pts"].shape)
    want = jax.jit(jbps.feature_edge_projections)(jnp.asarray(pts),
                                                  c["jbd"])
    got = bps.feature_edge_projections(torch.tensor(pts), c["tbd"])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=TOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[1].sum()) > 0
    sums, counts = map(np.asarray, jax.jit(jbps.surface_centroids)(
        jnp.asarray(pts), c["jtd"]))
    rows = c["tbd"]["smooth_rows"]
    got = bps.surface_centroids(_face_centres(pts, c["ttd"]), c["ttd"],
                                rows)
    rows = rows.numpy()
    assert len(rows) and (counts[rows] > 0).all()
    np.testing.assert_allclose(got.numpy(), sums[rows] / counts[rows, None],
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("name", CASES)
def test_project_boundary_points_matches(name):
    """The priority projection from a perturbed state, with normals
    from the mesh and some points frozen on entry; the ray cast is the
    plain version, in float64."""
    c = _case(name)
    rng = np.random.default_rng(4)
    pts = c["pts"] + 0.005 * rng.normal(size=c["pts"].shape)
    prop = pts + 0.01 * rng.normal(size=pts.shape)
    normals, sharp = jlay.boundary_point_normals_np(pts, c["jtopo"])
    frozen = rng.random(len(pts)) < 0.05

    def jax_project(p, q, n, f, s):
        return jbps.project_boundary_points(p, q, n, f, c["jbd"], c["jtd"],
                                            s)

    want = jax.jit(jax_project)(*map(jnp.asarray,
                                     (pts, prop, normals, frozen, sharp)))
    T = torch.tensor
    got = bps.project_boundary_points(
        T(pts), T(prop), T(normals), T(frozen), c["tbd"], c["ttd"],
        T(sharp), _face_centres(pts, c["ttd"]),
        ray_cast=raycast.segment_triangle_hits_plain)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the top points snap onto the dome
    rows = c["tbd"]["surf_rows"].numpy()
    hit = ~got[2].numpy()[rows]
    assert hit.all() and not np.allclose(got[0].numpy()[rows], prop[rows])


def _random_soup(dtype):
    """The soup and rays of tests/test_boundary.py
    (test_pallas_raycast_matches_jnp): T = 300, B = 500."""
    rng = np.random.default_rng(0)
    T = 300
    a = (rng.random((T, 3)) * 2).astype(np.float32)
    b = a + (rng.random((T, 3)) * 0.5).astype(np.float32)
    c = a + (rng.random((T, 3)) * 0.5).astype(np.float32)
    B = 500
    o = (rng.random((B, 3)) * 2).astype(np.float32)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return [x.astype(dtype) for x in (a, b, c, o, d)]


def _dome_rays(name):
    """Rays from the testcase's top points along +-z against its dome:
    many hit exactly on edges shared by two triangles."""
    c = _case(name)
    V, T = c["geometry"][:2]
    top = c["pts"][c["pts"][:, 2] > 0.999]
    o = np.concatenate([top, top + [0.0, 0.0, 0.5]])
    d = np.tile([0.0, 0.0, 1.0], (len(o), 1))
    return V[T[:, 0]], V[T[:, 1]], V[T[:, 2]], o, d


def _assert_hits_close(got, want, **tol):
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], **tol)


@pytest.mark.parametrize("soup", ["random", "tc5-dome"])
def test_ray_cast_plain_matches_xla_f64(soup):
    a, b, c, o, d = (_random_soup(np.float64) if soup == "random"
                     else _dome_rays("tc5"))
    want = _jax_hits(*map(jnp.asarray, (o, d)), 10.0,
                     *map(jnp.asarray, (a, b, c)))
    packed = torch.tensor(raycast.pack_triangles(a, b, c, np.float64))
    got = raycast.segment_triangle_hits_plain(torch.tensor(o),
                                              torch.tensor(d), 10.0, packed)
    _assert_hits_close(got, want, rtol=0, atol=TOL)
    assert np.isfinite(got[0].numpy()).sum() > 0
    assert np.isfinite(got[1].numpy()).sum() > 0
    # chunks of rays give the same result; so does the CPU wrapper
    chunked = raycast.segment_triangle_hits_plain(
        torch.tensor(o), torch.tensor(d), 10.0, packed, chunk=7)
    wrapped = raycast.segment_triangle_hits(torch.tensor(o),
                                            torch.tensor(d), 10.0, packed)
    for x, y, z in zip(got, chunked, wrapped):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
        np.testing.assert_array_equal(x.numpy(), z.numpy())
    if soup == "tc5-dome":
        # every top point lies under the dome: t_pos hits, t_neg does not
        n_top = len(o) // 2
        assert np.isfinite(got[0].numpy()[:n_top]).all()


def test_ray_cast_plain_matches_pallas_f32():
    a, b, c, o, d = _random_soup(np.float32)
    want = segment_triangle_hits_pallas(
        o, d, 10.0, jnp.asarray(jax_pack(a, b, c)), len(a))
    packed = raycast.pack_triangles(a, b, c, np.float32)
    np.testing.assert_array_equal(packed, jax_pack(a, b, c)[:, :len(a)])
    got = raycast.segment_triangle_hits_plain(
        torch.tensor(o), torch.tensor(d), 10.0, torch.tensor(packed))
    assert got[0].dtype == torch.float32
    _assert_hits_close(got, want, rtol=1e-4, atol=1e-6)


def test_ray_cast_refuses_other_devices():
    o = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        raycast.segment_triangle_hits(o, o, 1.0, torch.zeros(
            (9, 2), device="meta"))
