"""The port's boundary-layer module (``smoothmesh_torch.layers``) and
boundary point normals against the JAX package's, on the meshes of the
testcases tc5 (boundary smoothing + layers) and tc7 (boundary
smoothing): the host builders array-equal on the same topology, the
per-iteration functions to 1e-12 in float64 on inputs made from a seed.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from smoothmesh_tpu import geometry as jgeo
from smoothmesh_tpu import layers as jlay
from smoothmesh_tpu import testcases as jtc
from smoothmesh_tpu.device import to_device as jax_to_device
from smoothmesh_tpu.mesh.topology import compile_topology as jax_compile
from smoothmesh_torch import geometry as geo
from smoothmesh_torch import layers as lay
from smoothmesh_torch import testcases as ttc
from smoothmesh_torch.device import to_device
from smoothmesh_torch.mesh.topology import compile_topology

CASES = ["tc5", "tc7"]
TOL = 1e-12
_blend = jax.jit(jlay.blend_with_orthogonal_points,
                 static_argnums=(6, 7, 8, 9, 10))
_prismatic = jax.jit(jlay.project_prismatic_boundary_points,
                     static_argnums=(8,))


@functools.lru_cache(maxsize=None)
def _case(name):
    """(JAX topology, JAX device topology, port topology, port device
    topology, points, resolved JAX params) of a testcase's mesh."""
    jt, tt = jtc.ALL[name](), ttc.ALL[name]()
    np.testing.assert_array_equal(jt.mesh.points, tt.mesh.points)
    jtopo, ttopo = jax_compile(jt.mesh), compile_topology(tt.mesh)
    return (jtopo, jax_to_device(jtopo), ttopo, to_device(ttopo, "cpu"),
            tt.mesh.points, jt.params)


def _layer_ids(topo):
    return topo.patch_ids_matching(("top",))


def _assert_fields_equal(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        np.testing.assert_array_equal(va, vb, err_msg=f.name)
        assert va.dtype == vb.dtype, f.name


@pytest.mark.parametrize("name", CASES)
def test_host_builders_match(name):
    jtopo, _, ttopo, _, pts, params = _case(name)
    jn, js = jlay.boundary_point_normals_np(pts, jtopo)
    conn = lay.connected_to_internal(ttopo)
    np.testing.assert_array_equal(conn, jlay.connected_to_internal(jtopo))
    np.testing.assert_array_equal(
        lay.patch_point_mask(ttopo, _layer_ids(ttopo)),
        jlay.patch_point_mask(jtopo, _layer_ids(jtopo)))
    np.testing.assert_array_equal(
        lay.point_hops_to_boundary(ttopo, _layer_ids(ttopo), conn, 5),
        jlay.point_hops_to_boundary(jtopo, _layer_ids(jtopo), conn, 5))
    smooth = jtopo.patch_ids_matching(params.smoothing_patches)
    want = jlay.build_layer_maps(jtopo, jn, js, _layer_ids(jtopo), smooth,
                                 params.max_layers)
    got = lay.build_layer_maps(ttopo, jn, js, _layer_ids(ttopo), smooth,
                               params.max_layers)
    _assert_fields_equal(got, want)
    # the maps are not vacuous: layer stacks and inner neighbours exist
    assert (got.outer_map >= 0).sum() > 0
    assert (got.inner_map >= 0).sum() > 0


@pytest.mark.parametrize("name", CASES)
def test_boundary_point_normals_match(name):
    _, jtd, _, ttd, pts, _ = _case(name)
    want = jax.jit(jgeo.boundary_point_normals)(jnp.asarray(pts), jtd)
    got = geo.boundary_point_normals(torch.tensor(pts), ttd)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=0, atol=TOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int((np.asarray(want[2]) > 0).sum()) > 0
    assert bool((got[0] != 0).any(1).any())


@pytest.mark.parametrize("name", ["tc5"])
def test_accumulate_point_normals_matches(name):
    """Two accumulations from a random previous field (the normals are
    state: each iteration adds to the last)."""
    _, jtd, _, ttd, pts, _ = _case(name)
    rng = np.random.default_rng(1)
    prev = rng.normal(size=pts.shape)
    t_areas = geo.face_centres_areas(
        torch.tensor(pts), ttd["face_points"], ttd["face_mask"],
        ttd["face_npoints"]).areas
    step = jax.jit(lambda n: jlay.accumulate_point_normals(
        jnp.asarray(pts), jtd, n, face_areas=jnp.asarray(t_areas.numpy())))
    want, got = jnp.asarray(prev), torch.tensor(prev)
    for _ in range(2):
        want, want_sharp = step(want)
        got, got_sharp = lay.accumulate_point_normals(got, t_areas, ttd)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL)
        np.testing.assert_array_equal(got_sharp.numpy(),
                                      np.asarray(want_sharp))


@pytest.mark.parametrize("name", ["tc5"])
def test_layer_blend_and_prismatic_projection_match(name):
    jtopo, jtd, ttopo, ttd, pts, params = _case(name)
    p = params.resolve(0.1)
    rng = np.random.default_rng(2)
    prop = pts + 0.02 * rng.normal(size=pts.shape)
    normals, sharp = jlay.boundary_point_normals_np(pts, jtopo)
    smooth = ttopo.patch_ids_matching(p.smoothing_patches)
    maps = lay.build_layer_maps(ttopo, normals, sharp, _layer_ids(ttopo),
                                smooth, p.max_layers)
    normals = maps.normals_init
    J, T = jnp.asarray, torch.tensor
    big = jnp.asarray(1e18)

    outer = jlay.update_neigh_coords(J(pts), J(maps.outer_map),
                                     J(maps.outer_map) >= 0, big)
    got_outer = lay.update_neigh_coords(T(pts), T(maps.outer_map))
    np.testing.assert_array_equal(got_outer.numpy(), np.asarray(outer))
    args = (p.layer_max_blending_fraction, p.layer_edge_length,
            p.layer_expansion_ratio, p.min_layers, p.max_layers + 1)
    want = _blend(
        J(pts), J(prop), jtd, J(maps.hops_layer), J(normals), outer, *args)
    got = lay.blend_with_orthogonal_points(
        T(pts), T(prop), ttd, T(maps.hops_layer), T(normals), got_outer,
        *args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
    assert not np.allclose(got.numpy(), prop)     # some points blend

    bd = {"smoothing_surface": maps.smoothing_surface,
          "is_connected": maps.is_connected, "inner_map": maps.inner_map,
          "is_feature_edge": np.zeros(len(pts), bool),
          "is_corner": pts[:, 0] < 0.01}
    inner = jlay.update_neigh_coords(J(pts), J(maps.inner_map),
                                     J(maps.inner_map) >= 0, big)
    got_inner = lay.update_neigh_coords(T(pts), T(maps.inner_map))
    np.testing.assert_array_equal(got_inner.numpy(), np.asarray(inner))
    for frac in (0.0, 0.6):
        want = _prismatic(
            J(prop), jtd, {k: J(v) for k, v in bd.items()}, J(normals),
            inner, J(bd["is_feature_edge"]), J(bd["is_corner"]), J(sharp),
            frac)
        got = lay.project_prismatic_boundary_points(
            T(prop), {k: T(v) for k, v in bd.items()}, T(normals),
            got_inner, T(sharp), frac)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL)
    assert not np.allclose(got.numpy(), prop)     # some points project
