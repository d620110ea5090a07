"""The port's Smoother (device="cpu", float64: the plain versions of
K1-K4 plus the iteration glue) against the JAX package's Smoother on
its XLA path, both with face_angle_constraint=False: residuals to 1e-9
relative, equal frozen counts at every iteration, and denormalized
points to 1e-9 — from the mesh, and from the JAX smoother's state
carried across.  Plus the relTol stop, the run loop's log lines and
writes, and the configurations this slice refuses."""

import dataclasses

import numpy as np
import pytest
import torch

from smoothmesh_tpu.driver import Smoother as JaxSmoother
from smoothmesh_tpu.mesh.blockmesh import hex_block as jax_hex
from smoothmesh_tpu.mesh.blockmesh import perturb as jax_perturb
from smoothmesh_tpu.params import SmoothingParams as JaxParams
from smoothmesh_torch.convert import state_from_jax
from smoothmesh_torch.driver import Smoother
from smoothmesh_torch.mesh.blockmesh import hex_block, perturb
from smoothmesh_torch.params import SmoothingParams

ITERS = 6


def _mesh():
    return perturb(hex_block(n=(10, 8, 8)), amplitude=0.06, seed=7)


def _jax_smoother(**kw):
    mesh = jax_perturb(jax_hex(n=(10, 8, 8)), amplitude=0.06, seed=7)
    return JaxSmoother(mesh, JaxParams(face_angle_constraint=False, **kw),
                       dtype=np.float64, use_tile_engine=False)


def _smoother(**kw):
    return Smoother(_mesh(), SmoothingParams(face_angle_constraint=False,
                                             **kw),
                    device="cpu", dtype=torch.float64)


def _assert_same_run(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.iteration == w.iteration
        assert g.residual == pytest.approx(w.residual, rel=1e-9)
        assert g.n_frozen == w.n_frozen


def test_smoother_matches_jax_f64():
    kw = dict(centroidal_iters=ITERS, rel_tol=0.0)
    sj = _jax_smoother(**kw)
    want = sj.steps(ITERS)
    st = _smoother(**kw)
    assert st.points.dtype == torch.float64
    got = st.steps(ITERS)
    _assert_same_run(got, want)
    assert 0 < got[-1].n_frozen < st.topo.n_points
    moved = np.abs(st.denormalize() - _mesh().points).max()
    assert moved > 1e-3
    np.testing.assert_allclose(st.denormalize(), sj.denormalize(), rtol=0,
                               atol=1e-9)


def test_state_from_jax_matches():
    kw = dict(centroidal_iters=ITERS, rel_tol=0.0)
    sj = _jax_smoother(**kw)
    sj.steps(2)                 # carry a state that has already moved
    topo = {f.name: getattr(sj.topo, f.name)
            for f in dataclasses.fields(sj.topo)}
    st = state_from_jax(np.asarray(sj.points), topo,
                        dataclasses.asdict(sj.params), sj._center,
                        sj._scale, device="cpu", dtype=torch.float64)
    np.testing.assert_array_equal(st.denormalize(), sj.denormalize())
    want = sj.steps(ITERS - 2)
    got = st.steps(ITERS - 2)
    for g, w in zip(got, want):
        assert g.residual == pytest.approx(w.residual, rel=1e-9)
        assert g.n_frozen == w.n_frozen
    assert len(got) == len(want) == ITERS - 2
    np.testing.assert_allclose(st.denormalize(), sj.denormalize(), rtol=0,
                               atol=1e-9)


def test_rel_tol_stop_matches_jax():
    # a max step large enough for the residual to fall within a few
    # iterations (1.0, 1.0, 0.23, 0.12, 0.079, 0.054, 0.039, ...)
    kw = dict(centroidal_iters=15, rel_tol=0.05, max_step_length=0.05)
    want = _jax_smoother(**kw).steps(15)
    got = _smoother(**kw).steps(15)
    assert 3 < len(got) < 15
    _assert_same_run(got, want)
    assert got[-1].residual < 0.05 <= got[-2].residual


def test_run_logs_and_writes():
    st = _smoother(centroidal_iters=5, rel_tol=0.0, write_interval=2)
    lines, writes = [], []
    res = st.run(log=lines.append,
                 on_write=lambda it, pts: writes.append((it, pts.copy())))
    assert res.iteration == 5
    iters = [ln for ln in lines if ln.startswith("Smoothing iteration=")]
    assert len(iters) == 5
    assert iters[0].startswith("Smoothing iteration=1 nFrozenPoints=")
    assert "residual=" in iters[0]
    assert "Maximum centroidalIters reached, stopping." in lines
    assert [it for it, _ in writes] == [2, 4, 5]
    np.testing.assert_array_equal(writes[-1][1], st.denormalize())
    assert writes[-1][1].shape == _mesh().points.shape


def test_unsupported_configurations_raise():
    mesh = hex_block(n=(4, 4, 4), patches={"top": ["zmax"],
                                           "rest": ["xmin", "xmax", "ymin",
                                                    "ymax", "zmin"]})
    with pytest.raises(NotImplementedError, match="face-angle"):
        Smoother(mesh, SmoothingParams(), device="cpu")
    with pytest.raises(NotImplementedError, match="layer"):
        Smoother(mesh, SmoothingParams(face_angle_constraint=False,
                                       layer_patches=("top",)),
                 device="cpu")
    st = Smoother(mesh, SmoothingParams(face_angle_constraint=False,
                                        layer_patches=("nomatch",)),
                  device="cpu")
    with pytest.raises(NotImplementedError, match="boundary"):
        st.enable_boundary_smoothing(None, None, None, None)
