"""The port's face and cell geometry (the plain versions behind K1 and
K2) against the JAX package: its XLA functions in float64 at 1e-12, and
its Pallas stages F and C (TiledEngine, interpret mode) in float32 at
2e-6 / 5e-6 — the tolerances of tests/test_tiledstep.py, on the same
unit-scale meshes."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from smoothmesh_tpu import geometry as jgeo
from smoothmesh_tpu.device import to_device as jax_to_device
from smoothmesh_tpu.mesh.blockmesh import hex_block, perturb, prism_block
from smoothmesh_tpu.mesh.tiling import permute_mesh
from smoothmesh_tpu.mesh.topology import compile_topology
from smoothmesh_tpu.ops.tiled import from_planar, to_planar
from smoothmesh_tpu.ops.tiledstep import TiledEngine
from smoothmesh_torch import geometry as geo
from smoothmesh_torch.device import to_device
from smoothmesh_torch.mesh.topology import MeshTopology

torch.set_num_threads(1)

MESHES = {
    "hex": perturb(hex_block(n=(14, 12, 10)), amplitude=0.05, seed=5),
    "prism": perturb(prism_block(n=(8, 8, 6)), amplitude=0.04, seed=6),
}

_TOPO_FIELDS = [f.name for f in dataclasses.fields(MeshTopology)]


@functools.lru_cache(maxsize=None)
def _engine(kind):
    """One interpret-mode TiledEngine per mesh, shared by the tests."""
    return TiledEngine(_setup(kind)[1], interpret=True)


@functools.lru_cache(maxsize=None)
def _setup(kind):
    mesh, _ = permute_mesh(MESHES[kind])
    jtopo = compile_topology(mesh)
    # the same tables in the port's own topology type
    topo = MeshTopology(**{k: getattr(jtopo, k)
                           for k in _TOPO_FIELDS})
    return mesh, jtopo, jax_to_device(jtopo), to_device(topo, "cpu")


def _fg(pts, td):
    return geo.face_centres_areas(pts, td["face_points"], td["face_mask"],
                                  td["face_npoints"])


@pytest.mark.parametrize("kind", ["hex", "prism"])
def test_geometry_matches_xla_f64(kind):
    mesh, _, jtd, td = _setup(kind)
    pts = torch.from_numpy(np.asarray(mesh.points, np.float64))
    fg = _fg(pts, td)
    jfg = jgeo.face_centres_areas(
        jnp.asarray(mesh.points, jnp.float64), jtd["face_points"],
        jtd["face_points_next"], jtd["face_mask"], jtd["face_npoints"])
    np.testing.assert_allclose(fg.centres.numpy(), np.asarray(jfg.centres),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(fg.areas.numpy(), np.asarray(jfg.areas),
                               rtol=0, atol=1e-12)
    fp, fm = td["face_points"].numpy(), td["face_mask"].numpy()
    vm = (mesh.points[fp] * fm[..., None]).sum(1) / fm.sum(1)[:, None]
    np.testing.assert_allclose(fg.means.numpy(), vm, rtol=0, atol=1e-12)

    cc, vol = geo.cell_centres_vols(fg, td)
    jcc, jvol = jgeo.cell_centres_vols(jfg, jtd["owner"], jtd["cell_faces"],
                                       jtd["cell_faces_mask"])
    np.testing.assert_allclose(cc.numpy(), np.asarray(jcc), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(vol.numpy(), np.asarray(jvol), rtol=0,
                               atol=1e-12)
    assert (vol > 0).all()
    np.testing.assert_allclose(geo.cell_centres(pts, td).numpy(),
                               np.asarray(jcc), rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind", ["hex", "prism"])
def test_geometry_matches_pallas_f32(kind):
    mesh, jtopo, _, td = _setup(kind)
    eng = _engine(kind)
    jpts = jnp.asarray(mesh.points, jnp.float32)
    geom6, vm3 = eng.face_geometry(eng.arrays, to_planar(jpts))
    cc4 = eng.cell_centres_vols(eng.arrays, geom6)

    pts = torch.from_numpy(np.asarray(mesh.points, np.float32))
    fg = _fg(pts, td)
    F, C = jtopo.n_faces, jtopo.n_cells
    for got, want in ((fg.centres, geom6[:3]), (fg.areas, geom6[3:6]),
                      (fg.means, vm3)):
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(from_planar(want, F)),
                                   rtol=0, atol=2e-6)
    cc, vol = geo.cell_centres_vols(fg, td)
    assert cc.dtype == torch.float32
    np.testing.assert_allclose(cc.numpy(),
                               np.asarray(from_planar(cc4[:3], C)),
                               rtol=0, atol=5e-6)
    np.testing.assert_allclose(vol.numpy(),
                               np.asarray(from_planar(cc4[3:4], C))[:, 0],
                               rtol=0, atol=5e-6)
