"""The port's fused predictor (the plain version behind K3) against the
JAX package: its XLA chain (centroidal -> aspect-ratio blend -> step
limiter) in float64 at 1e-12, and its Pallas stage P (TiledEngine,
interpret mode) in float32 at 3e-6, with boundary smoothing off and on.
The float32 comparison pins max_step above the raw step range so that
the limiter's discontinuity at |step| == max_step cannot decide it."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smoothmesh_tpu import geometry as jgeo
from smoothmesh_tpu.device import to_device as jax_to_device
from smoothmesh_tpu.mesh.blockmesh import hex_block, perturb, prism_block
from smoothmesh_tpu.mesh.tiling import permute_mesh
from smoothmesh_tpu.mesh.topology import compile_topology
from smoothmesh_tpu.ops import smoothing as jsm
from smoothmesh_tpu.ops.tiled import from_planar, to_planar
from smoothmesh_tpu.ops.tiledstep import TiledEngine
from smoothmesh_torch import geometry as geo
from smoothmesh_torch.device import to_device
from smoothmesh_torch.mesh.topology import MeshTopology
from smoothmesh_torch.ops import smoothing as sm

MESHES = {
    "hex": perturb(hex_block(n=(14, 12, 10)), amplitude=0.05, seed=5),
    "prism": perturb(prism_block(n=(8, 8, 6)), amplitude=0.04, seed=6),
}
RSF = 0.5

_TOPO_FIELDS = [f.name for f in dataclasses.fields(MeshTopology)]


@functools.lru_cache(maxsize=None)
def _engine(kind):
    """One interpret-mode TiledEngine per mesh, shared by the tests."""
    return TiledEngine(_setup(kind)[1], interpret=True)


@functools.lru_cache(maxsize=None)
def _setup(kind):
    mesh, _ = permute_mesh(MESHES[kind])
    jtopo = compile_topology(mesh)
    topo = MeshTopology(**{k: getattr(jtopo, k)
                           for k in _TOPO_FIELDS})
    return mesh, jtopo, jax_to_device(jtopo), to_device(topo, "cpu")


@functools.partial(jax.jit, static_argnums=3)
def _jax_chain(pts, jtd, max_step, do_boundary):
    """The JAX XLA predictor chain; one jit builds some 5x quicker here
    than its ops run eagerly."""
    cc = jgeo.cell_centres(pts, jtd)
    cent = jsm.centroidal_smoothing(pts, cc, jtd, do_boundary)
    prop = jsm.aspect_ratio_smoothing(pts, cent, jtd)
    return cc, prop, jsm.constrain_max_step_length(pts, prop, max_step, RSF)


def _curmin(pts, td):
    pp, m = td["point_points"].numpy(), td["point_points_mask"].numpy()
    L = np.linalg.norm(pts[pp] - pts[:, None, :], axis=-1)
    return np.where(m, L, np.inf).min(1)


@pytest.mark.parametrize("kind", ["hex", "prism"])
@pytest.mark.parametrize("do_boundary", [False, True])
def test_predictor_matches_xla_f64(kind, do_boundary):
    mesh, _, jtd, td = _setup(kind)
    jpts = jnp.asarray(mesh.points, jnp.float64)
    max_step = 0.013                  # below the raw range: rescales
    jcc, _, want = _jax_chain(jpts, jtd, max_step, do_boundary)

    pts = torch.from_numpy(np.asarray(mesh.points, np.float64))
    cc = geo.cell_centres(pts, td)
    np.testing.assert_allclose(cc.numpy(), np.asarray(jcc), rtol=0,
                               atol=1e-12)
    prop, curmin = sm.predictor(pts, cc, td, max_step, RSF, do_boundary)
    np.testing.assert_allclose(prop.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)
    moved = np.linalg.norm(prop.numpy() - mesh.points, axis=1)
    assert moved.max() > 1e-3 and (moved > 1e-6).mean() > 0.3
    np.testing.assert_allclose(curmin.numpy(), _curmin(mesh.points, td),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind", ["hex", "prism"])
@pytest.mark.parametrize("do_boundary", [False, True])
def test_predictor_matches_pallas_f32(kind, do_boundary):
    mesh, jtopo, jtd, td = _setup(kind)
    jpts = jnp.asarray(mesh.points, jnp.float32)
    # pin max_step above every raw step of this input
    _, raw, _ = _jax_chain(jnp.asarray(mesh.points, jnp.float64), jtd,
                           1.0, do_boundary)
    raw_max = float(np.linalg.norm(np.asarray(raw) - mesh.points,
                                   axis=1).max())
    max_step = 2.0 * raw_max

    eng = _engine(kind)
    geom6, _ = eng.face_geometry(eng.arrays, to_planar(jpts))
    cc4 = eng.cell_centres_vols(eng.arrays, geom6)
    out4 = eng.predictor(eng.arrays, eng.pts4(jpts), cc4, max_step, RSF,
                         do_boundary)
    n = jtopo.n_points

    pts = torch.from_numpy(np.asarray(mesh.points, np.float32))
    cc = torch.tensor(np.asarray(from_planar(cc4[:3], jtopo.n_cells)))
    prop, curmin = sm.predictor(pts, cc, td, max_step, RSF, do_boundary)
    assert prop.dtype == torch.float32
    np.testing.assert_allclose(prop.numpy(),
                               np.asarray(from_planar(out4[:3], n)),
                               rtol=0, atol=3e-6)
    np.testing.assert_allclose(curmin.numpy(),
                               np.asarray(from_planar(out4[3:4], n))[:, 0],
                               rtol=0, atol=3e-6)


@pytest.mark.parametrize("kind", ["hex", "prism"])
def test_residual_and_limiter_match_xla(kind):
    mesh, _, jtd, _ = _setup(kind)
    rng = np.random.default_rng(11)
    prop = mesh.points + rng.normal(scale=0.02, size=mesh.points.shape)
    t = torch.from_numpy
    got = sm.constrain_max_step_length(t(mesh.points), t(prop), 0.013, RSF)
    want = jsm.constrain_max_step_length(jnp.asarray(mesh.points),
                                         jnp.asarray(prop), 0.013, RSF)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-15)
    assert float(sm.calculate_residual(t(mesh.points), got, 0.013)) == \
        pytest.approx(float(jsm.calculate_residual(
            jnp.asarray(mesh.points), want, 0.013)), rel=1e-14)
