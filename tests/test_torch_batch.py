"""The port's batched ``Smoother.steps`` (``iter_batch`` iterations a
dispatch, one host read a batch; here 4, on the CPU, so the batch
iteration runs eagerly) against the JAX package's batched ``steps``:
residuals to 1e-9 relative, equal frozen and ray-miss counts, equal
iteration numbers and denormalized points to 1e-9 in float64, on the
JAX runs that ``tests/test_torch_driver.py`` caches (imported, so no
JAX smoother is built here that it does not build).

Cases: ``steps(6)`` with the face angle off and in the boundary runs
tc7 and tc5 (a full batch and a partial one); at the default band and
at 60/120, where points are in the face-angle band from the first
iteration, so the batch stops uncommitted there (a face-angle stop) and
the host runs the rest one iteration at a time; the relTol stop inside
the second batch; and a fatal ray miss, which stops a batch of 4 after
its first slot, commits and counts that iteration and raises.  Beside
them the batched and the one-by-one paths are held bit-equal in float64
and float32, the batch is read once, and it is built anew when what it
captured is replaced."""

import dataclasses

import numpy as np
import pytest
import torch

import test_torch_driver as drv
from smoothmesh_torch import driver
from smoothmesh_torch import testcases as ttc
from smoothmesh_torch.driver import Smoother
from smoothmesh_torch.mesh.blockmesh import hex_block
from smoothmesh_torch.params import SmoothingParams

torch.set_num_threads(1)

B = 4


def _batched(st: Smoother) -> Smoother:
    st.iter_batch = B
    return st


@pytest.fixture
def reads(monkeypatch):
    """Counts the batches run (each one host read of its record)."""
    counted = []
    run = driver._Batch.run

    def counting(self, points, normals, n):
        counted.append(n)
        return run(self, points, normals, n)

    monkeypatch.setattr(driver._Batch, "run", counting)
    return counted


def test_face_angle_off_matches_jax(reads):
    want, want_pts = drv._jax_run("plain")
    st = _batched(drv._smoother(**drv.RUNS["plain"]))
    got = st.steps(drv.ITERS)
    drv._assert_same_run(got, want)
    assert reads == [B, drv.ITERS - B]     # a full batch, a partial one
    assert st.face_angle_stops == 0
    np.testing.assert_allclose(st.denormalize(), want_pts, rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("band", list(drv.BANDS))
def test_face_angle_stop_matches_jax(band, reads):
    want, _, want_pts = drv._jax_face_angle_run(band)
    st = _batched(drv._smoother(face_angle_constraint=True,
                                centroidal_iters=drv.ITERS, rel_tol=0.0,
                                **drv.BANDS[band]))
    got = st.steps(drv.ITERS)
    drv._assert_same_run(got, want)
    # points are in the band from the first iteration: one batch stops
    # there uncommitted, the rest runs one iteration at a time
    assert reads == [B] and st.face_angle_stops == 1
    np.testing.assert_allclose(st.denormalize(), want_pts, rtol=0,
                               atol=1e-9)


def test_rel_tol_stop_inside_a_batch_matches_jax(reads):
    want, _ = drv._jax_run("rel_tol")
    st = _batched(drv._smoother(**drv.RUNS["rel_tol"]))
    got = st.steps(15)
    drv._assert_same_run(got, want)
    assert B < len(got) < 2 * B          # inside the second batch
    assert reads == [B, B]
    assert got[-1].residual < 0.05 <= got[-2].residual


@pytest.mark.parametrize("name", drv.BND_CASES)
def test_boundary_matches_jax(name, reads):
    want, _, want_pts = drv._jax_boundary_run(name)
    tc, params = drv._bnd_case(ttc, name)
    st = _batched(Smoother(tc.mesh, params, device="cpu",
                           dtype=torch.float64))
    st.enable_boundary_smoothing(*tc.geometry)
    assert params.face_angle_constraint
    got = st.steps(drv.ITERS)
    drv._assert_same_run(got, want)
    assert reads == [B, drv.ITERS - B] and st.face_angle_stops == 0
    np.testing.assert_allclose(st.denormalize(), want_pts, rtol=0,
                               atol=1e-9)


def test_fatal_ray_miss_matches_jax(reads):
    """As ``test_unsupported_configurations_raise``: the offending
    iteration committed and counted, then the raise; here the miss
    stops a batch of 4 after its first slot."""
    mesh = hex_block(n=(4, 4, 4), patches=ttc.TOP_PATCHES)
    st = _batched(Smoother(mesh, SmoothingParams(**drv.FATAL_MISS),
                           device="cpu", dtype=torch.float64))
    st.enable_boundary_smoothing(*drv._half_dome())
    before = st.denormalize()
    with pytest.raises(RuntimeError, match=r"for 6 smoothing-surface"):
        st.steps(B)
    jax_iteration, jax_points = drv._jax_fatal_miss_run()
    assert reads == [B]
    assert st._iteration == jax_iteration == 1
    after = st.denormalize()
    assert np.abs(after - before).max() > 1e-3          # committed
    np.testing.assert_allclose(after, jax_points, rtol=0, atol=1e-12)


def _run(dtype, batch, n, boundary=False, **kw):
    if boundary:
        tc, params = drv._bnd_case(ttc, "tc5")
        st = Smoother(tc.mesh, params, device="cpu", dtype=dtype)
        st.enable_boundary_smoothing(*tc.geometry)
    else:
        st = Smoother(drv._mesh(), SmoothingParams(**{"rel_tol": 0.0, **kw}),
                      device="cpu", dtype=dtype)
    st.iter_batch = batch
    rs = st.steps(n)
    return [dataclasses.astuple(r)[:3] + (r.n_ray_miss,) for r in rs], st


#: the configurations held bit-equal (the boundary one is tc5's, with
#: layers and the face angle on)
CONFIGS = {
    "face angle off": dict(face_angle_constraint=False),
    "60-120": dict(face_angle_constraint=True, min_angle=60.0,
                   max_angle=120.0),
    "rel_tol": dict(face_angle_constraint=False, rel_tol=0.05,
                    max_step_length=0.05),
    "boundary": dict(boundary=True),
}


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_batched_equals_one_by_one(config, dtype):
    kw = CONFIGS[config]
    one, st1 = _run(dtype, 1, 9, **kw)
    batched, stb = _run(dtype, B, 9, **kw)
    assert batched == one
    assert len(one) == (7 if config == "rel_tol" else 9)
    assert torch.equal(stb.points, st1.points)
    assert torch.equal(stb.normals, st1.normals)


def test_batch_is_built_anew_when_its_inputs_change():
    tc, params = drv._bnd_case(ttc, "tc7")
    st = _batched(Smoother(tc.mesh, params, device="cpu",
                           dtype=torch.float64))
    st.steps(1)
    first = st._batch
    st.steps(1)
    assert st._batch is first                  # kept
    st.enable_boundary_smoothing(*tc.geometry)
    st.steps(1)
    assert st._batch is not first and st._batch._kw["bnd"] is st.bnd
    second = st._batch
    st.params = dataclasses.replace(st.params, rel_tol=0.5)
    st.steps(1)
    assert st._batch is not second
    assert st._iteration == 4
