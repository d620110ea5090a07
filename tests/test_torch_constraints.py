"""The port's freeze constraints (the plain version behind K4) against
the JAX package: restrict_edge_shortening +
restrict_min_edge_angle_decrease (XLA, clamped acos) in float64, and its
Pallas stage S (TiledEngine, interpret mode, clamped cosines) in
float32 — equal freeze masks; total_min_freeze both ways in float64."""

import dataclasses
import functools
import math

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
from smoothmesh_tpu.ops import constraints as jcon
from smoothmesh_tpu.ops import smoothing as jsm
from smoothmesh_tpu.ops.tiled import from_planar, to_planar
from smoothmesh_tpu.ops.tiledstep import TiledEngine
from smoothmesh_torch.device import to_device
from smoothmesh_torch.mesh.topology import MeshTopology
from smoothmesh_torch.ops import constraints as con

MESHES = {
    "hex": perturb(hex_block(n=(14, 12, 10)), amplitude=0.05, seed=5),
    "prism": perturb(prism_block(n=(8, 8, 6)), amplitude=0.04, seed=6),
}
MIN_EDGE = 0.04
MIN_ANGLE = math.radians(35.0)

_TOPO_FIELDS = [f.name for f in dataclasses.fields(MeshTopology)]


@functools.lru_cache(maxsize=None)
def _engine(kind):
    """One interpret-mode TiledEngine per mesh, shared by the tests."""
    return TiledEngine(_setup(kind, jnp.float32)[0], interpret=True)


@functools.lru_cache(maxsize=None)
def _setup(kind, dtype):
    mesh, _ = permute_mesh(MESHES[kind])
    jtopo = compile_topology(mesh)
    topo = MeshTopology(**{k: getattr(jtopo, k)
                           for k in _TOPO_FIELDS})
    jtd = jax_to_device(jtopo)
    pts = jnp.asarray(mesh.points, dtype)
    return jtopo, jtd, to_device(topo, "cpu"), pts, _jax_proposal(pts, jtd)


@jax.jit
def _jax_proposal(pts, jtd):
    """Centroidal + aspect ratio + step limit; one jit builds some 5x
    quicker here than its ops run eagerly."""
    cc = jgeo.cell_centres(pts, jtd)
    cent = jsm.centroidal_smoothing(pts, cc, jtd, False)
    prop = jsm.aspect_ratio_smoothing(pts, cent, jtd)
    return jsm.constrain_max_step_length(pts, prop, 0.02, 0.5)


@pytest.mark.parametrize("kind", ["hex", "prism"])
@pytest.mark.parametrize("tmf", [False, True])
def test_freeze_matches_xla_f64(kind, tmf):
    jtopo, jtd, td, jpts, jprop = _setup(kind, jnp.float64)
    n = jtopo.n_points
    want = jcon.restrict_edge_shortening(jpts, jprop, jtd, MIN_EDGE, tmf,
                                         jnp.zeros(n, dtype=bool))
    want = np.asarray(jcon.restrict_min_edge_angle_decrease(
        jpts, jprop, jtd, MIN_ANGLE, want))
    assert 0 < want.sum() < n

    pts = torch.tensor(np.asarray(jpts))
    prop = torch.tensor(np.asarray(jprop))
    none = torch.zeros(n, dtype=torch.bool)
    got = con.freeze_constraints(pts, prop, td, MIN_EDGE, tmf, MIN_ANGLE,
                                 True, none)
    np.testing.assert_array_equal(got.numpy(), want)
    # the reference formulation, ported as it is
    ref = con.restrict_edge_shortening(pts, prop, td, MIN_EDGE, tmf, none)
    ref = con.restrict_min_edge_angle_decrease(pts, prop, td, MIN_ANGLE, ref)
    np.testing.assert_array_equal(ref.numpy(), want)
    # each freeze alone, and OR into an incoming mask
    edge = con.freeze_constraints(pts, prop, td, MIN_EDGE, tmf, MIN_ANGLE,
                                  False, none)
    np.testing.assert_array_equal(edge.numpy(), np.asarray(
        jcon.restrict_edge_shortening(jpts, jprop, jtd, MIN_EDGE, tmf,
                                      jnp.zeros(n, dtype=bool))))
    some = torch.from_numpy(np.arange(n) % 7 == 0)
    both = con.freeze_constraints(pts, prop, td, MIN_EDGE, tmf, MIN_ANGLE,
                                  True, some)
    np.testing.assert_array_equal(both.numpy(), want | some.numpy())


@pytest.mark.parametrize("kind", ["hex", "prism"])
def test_freeze_matches_pallas_f32(kind):
    tmf = False   # both ways in float64 above; each way costs an
    #               interpret-mode compile of stage S here
    jtopo, _, td, jpts, jprop = _setup(kind, jnp.float32)
    n = jtopo.n_points
    eng = _engine(kind)
    p4 = eng.pts4(jpts)
    prop4 = jnp.concatenate(
        [to_planar(jprop), jnp.zeros((1, p4.shape[1]), jnp.float32)], 0)
    fz = eng.freeze_constraints(eng.arrays, p4, prop4,
                                jnp.zeros((1, p4.shape[1]), jnp.float32),
                                MIN_EDGE, tmf, MIN_ANGLE, True)
    want = np.asarray(from_planar(fz, n))[:, 0] > 0.5
    assert 0 < want.sum() < n

    got = con.freeze_constraints(
        torch.tensor(np.asarray(jpts)),
        torch.tensor(np.asarray(jprop)), td, MIN_EDGE, tmf, MIN_ANGLE,
        True, torch.zeros(n, dtype=torch.bool))
    np.testing.assert_array_equal(got.numpy(), want)
