"""The port's face-angle constraint against the JAX package:

- the plain per-edge pass (``current_face_angles_per_point``) against
  the JAX XLA function in float64, to 1e-12 rad;
- the plain versions behind K5 and K6 (``face_angles_per_point``)
  against the Pallas stages E and R (TiledEngine, interpret mode) in
  float32, in u units, to 1e-5;
- the fixed point ``restrict_face_angle_deterioration`` at an
  80/100 degree band: equal masks with the JAX function in float64 angle
  space and with the numpy stack oracle (``tests/oracle.py``), and equal
  masks with the JAX function in float32 u space when both get the same
  current angles (the card's path);
- the fixed point against the oracle alone where pair sweeps bite: the
  prism at 80/100 with an incoming mask, and the first iteration of the
  driver tests' mesh at 35/160 and 60/120, where the JAX XLA function
  itself departs from the oracle at exact ties.

The JAX fixed point is traced with ``SMOOTHMESH_FA_SLOT_SCAN=1``: its
pair slots then run as a ``fori_loop`` instead of unrolled Python
(bit-identical by its own design note, ``constraints.py:409-412``),
which compiles ~3x faster here; the oracle comparison below holds the
JAX result itself as well.
"""

import contextlib
import dataclasses
import functools
import math

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import oracle
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

torch.set_num_threads(1)

MESHES = {
    # the fixture of tests/test_kernels_vs_oracle.py
    "oracle": lambda: perturb(hex_block(n=(4, 4, 4), grading=(3.0, 1.0, 0.3)),
                              0.02, seed=11),
    # the meshes of tests/test_tiledstep.py
    "hex": lambda: perturb(hex_block(n=(14, 12, 10)), amplitude=0.05, seed=5),
    "prism": lambda: perturb(prism_block(n=(8, 8, 6)), amplitude=0.04,
                             seed=6),
}
BAND = (math.radians(80.0), math.radians(100.0))

_TOPO_FIELDS = [f.name for f in dataclasses.fields(MeshTopology)]


@contextlib.contextmanager
def _slot_scan():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SMOOTHMESH_FA_SLOT_SCAN", "1")
        yield


def _t(a):
    return torch.tensor(np.asarray(a))


@functools.lru_cache(maxsize=None)
def _setup(kind, dtype):
    """JAX topology + td, the port's td, points, cell centres and a
    proposal (centroidal + aspect ratio + step limit) in ``dtype``."""
    mesh = MESHES[kind]()
    if kind != "oracle":
        mesh, _ = permute_mesh(mesh)
    jtopo = compile_topology(mesh)
    jtd = jax_to_device(jtopo)
    td = to_device(MeshTopology(**{k: getattr(jtopo, k)
                                   for k in _TOPO_FIELDS}), "cpu")
    pts = jnp.asarray(mesh.points, dtype)
    cc, prop = _jax_proposal(pts, jtd, kind == "oracle")
    return mesh, jtopo, jtd, td, pts, cc, prop


@functools.partial(jax.jit, static_argnums=2)
def _jax_proposal(pts, jtd, centroidal_only):
    """Cell centres and a proposal: centroidal (+ aspect ratio), step
    limit; for the oracle fixture as tests/test_kernels_vs_oracle.py
    makes it.  One jit is some 5x quicker to build here than eager."""
    cc = jgeo.cell_centres(pts, jtd)
    prop = jsm.centroidal_smoothing(pts, cc, jtd, False)
    if centroidal_only:
        return cc, jsm.constrain_max_step_length(pts, prop, 0.05, 0.5)
    prop = jsm.aspect_ratio_smoothing(pts, prop, jtd)
    return cc, jsm.constrain_max_step_length(pts, prop, 0.02, 0.5)


@functools.lru_cache(maxsize=None)
def _pallas_prism():
    """Stages F, C, E and R of an interpret-mode TiledEngine on the
    prism mesh (float32) -> (vertex means, cell centres, u_min, u_max)."""
    _, jtopo, _, _, pts, _, _ = _setup("prism", jnp.float32)
    eng = TiledEngine(jtopo, interpret=True)
    geom6, vm3 = eng.face_geometry(eng.arrays, to_planar(pts))
    cc4 = eng.cell_centres_vols(eng.arrays, geom6)
    u_min, u_max = eng.face_angles_per_point(eng.arrays, eng.pts4(pts),
                                             vm3, cc4)
    return (from_planar(vm3, jtopo.n_faces),
            from_planar(cc4[:3], jtopo.n_cells), u_min, u_max)


@pytest.mark.parametrize("kind", ["oracle", "hex", "prism"])
def test_current_face_angles_match_xla_f64(kind):
    _, _, jtd, td, pts, cc, _ = _setup(kind, jnp.float64)
    want = jax.jit(jcon.current_face_angles_per_point)(pts, cc, jtd)
    got = con.current_face_angles_per_point(_t(pts), _t(cc), td)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-12)
    # K5 + K6's plain versions give the u-space image of the same
    # angles (u loses precision near pi, where d acos / du grows)
    ue = con.edge_face_angles_plain(_t(pts), con.simple_face_centres(
        _t(pts), td), _t(cc), td)
    for u, g in zip(con.point_face_angles_plain(ue, td).unbind(1), got):
        u = u.numpy()
        ang = np.where(u <= 2.0, np.arccos(np.clip(1.0 - u, -1, 1)),
                       2.0 * np.pi - np.arccos(np.clip(u - 3.0, -1, 1)))
        np.testing.assert_allclose(ang, g.numpy(), rtol=0, atol=1e-6)


def test_face_angles_per_point_match_pallas_f32():
    _, _, _, td, pts, _, _ = _setup("prism", jnp.float32)
    means, cc, u_min, u_max = _pallas_prism()
    got = con.face_angles_per_point(_t(pts), _t(means), _t(cc), td)
    for g, w in zip(got, (u_min, u_max)):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)
    # the wrapper is the plain chain on CPU tensors
    plain = con.face_angles_per_point_plain(_t(pts), _t(means), _t(cc), td)
    for g, p in zip(got, plain):
        assert torch.equal(g, p)


def test_fixed_point_matches_xla_and_oracle_f64():
    mesh, jtopo, jtd, td, pts, cc, prop = _setup("oracle", jnp.float64)
    n = jtopo.n_points
    with _slot_scan():
        want = np.asarray(jcon.restrict_face_angle_deterioration(
            pts, cc, prop, jtd, *BAND, jnp.zeros(n, dtype=bool)))
    ref = oracle.face_angle_freeze(jtopo, mesh.points, np.asarray(cc),
                                   np.asarray(prop), 80.0, 100.0,
                                   np.zeros(n, dtype=bool))
    stats = {}
    got = con.restrict_face_angle_deterioration(
        _t(pts), _t(cc), _t(prop), td, *BAND,
        torch.zeros(n, dtype=torch.bool), stats=stats)
    assert ref.any()
    np.testing.assert_array_equal(want, ref)
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats["active"] > 0 and stats["sweeps"] >= 1


@pytest.mark.parametrize("kind", ["oracle", "prism"])
def test_fixed_point_matches_oracle(kind):
    """Against the serial stack closure alone (equal on these meshes;
    the oracle's face centres are summed afresh, so it may differ at
    exact ties on others), with an incoming mask on the prism."""
    mesh, jtopo, _, td, pts, cc, prop = _setup(kind, jnp.float64)
    n = jtopo.n_points
    inc = np.zeros(n, dtype=bool)
    if kind == "prism":
        inc[::17] = True
    ref = oracle.face_angle_freeze(jtopo, mesh.points, np.asarray(cc),
                                   np.asarray(prop), 80.0, 100.0, inc)
    got = con.restrict_face_angle_deterioration(
        _t(pts), _t(cc), _t(prop), td, *BAND, torch.from_numpy(inc))
    assert (ref & ~inc).any()
    np.testing.assert_array_equal(got.numpy(), ref)


def test_fixed_point_u_space_matches_xla_f32():
    """The card's path: u space, current angles from stages E and R
    handed to both, det_eps 1e-5; several pair sweeps on the prism."""
    _, jtopo, jtd, td, pts, _, prop = _setup("prism", jnp.float32)
    means, cc, u_min, u_max = _pallas_prism()
    n = jtopo.n_points
    with _slot_scan():
        want = np.asarray(jcon.restrict_face_angle_deterioration(
            pts, cc, prop, jtd, *BAND, jnp.zeros(n, dtype=bool),
            fc_base=means, cur_minmax=(u_min, u_max), u_space=True))
    stats = {}
    got = con.restrict_face_angle_deterioration(
        _t(pts), _t(cc), _t(prop), td, *BAND,
        torch.zeros(n, dtype=torch.bool), fc_base=_t(means),
        cur_minmax=(_t(u_min), _t(u_max)), u_space=True, stats=stats)
    assert 0 < want.sum() < n
    assert stats["sweeps"] > 1
    np.testing.assert_array_equal(got.numpy(), want)


def test_fixed_point_returns_at_once_when_in_band():
    _, jtopo, _, td, pts, cc, prop = _setup("oracle", jnp.float64)
    frozen = torch.from_numpy(np.arange(jtopo.n_points) % 5 == 0)
    stats = {}
    got = con.restrict_face_angle_deterioration(
        _t(pts), _t(cc), _t(prop), td, math.radians(5.0),
        math.radians(175.0), frozen, stats=stats)
    assert stats == {"active": 0, "sweeps": 0}
    assert torch.equal(got, frozen)


@pytest.mark.parametrize("band", [(35.0, 160.0), (60.0, 120.0)])
def test_fixed_point_matches_oracle_where_xla_branch_drifts(band):
    """The first iteration of the driver tests' mesh, in angle space:
    the port's single-path fixed point equals the stack oracle, pair
    sweeps included.  (On these inputs the JAX XLA function freezes 161
    and 371 points against the oracle's 113 and 269: it takes the
    current and the substituted angles from two arithmetic paths with
    no guard, so an edge that a substitution leaves unchanged can
    compare as a deterioration in the last bits.)"""
    from smoothmesh_torch import geometry as geo
    from smoothmesh_torch.driver import Smoother
    from smoothmesh_torch.mesh import blockmesh
    from smoothmesh_torch.ops import smoothing as smo
    from smoothmesh_torch.params import SmoothingParams

    sm = Smoother(blockmesh.perturb(blockmesh.hex_block(n=(10, 8, 8)),
                                    amplitude=0.06, seed=7),
                  SmoothingParams(min_angle=band[0], max_angle=band[1]),
                  device="cpu", dtype=torch.float64)
    p, td, pts = sm.params, to_device(sm.topo, "cpu"), sm.points
    cc = geo.cell_centres(pts, td)
    prop, _ = smo.predictor(pts, cc, td, p.max_step_length * sm._scale,
                            p.rel_step_frac, False)
    frozen = con.freeze_constraints(
        pts, prop, td, p.min_edge_length * sm._scale, p.total_min_freeze,
        p.min_angle_rad, True, torch.zeros(len(pts), dtype=torch.bool))
    stats = {}
    got = con.restrict_face_angle_deterioration(
        pts, cc, prop, td, p.min_angle_rad, p.max_angle_rad, frozen,
        stats=stats)
    ref = oracle.face_angle_freeze(sm.topo, pts.numpy(), cc.numpy(),
                                   prop.numpy(), *band, frozen.numpy())
    assert stats["sweeps"] >= 2 and (ref & ~frozen.numpy()).sum() > 50
    np.testing.assert_array_equal(got.numpy(), ref)
