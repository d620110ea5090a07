"""The port's Smoother (device="cpu", float64: the plain versions of
K1-K4, the face-angle fixed point and the iteration glue) against the
JAX package's Smoother on its XLA path: residuals to 1e-9 relative,
equal frozen counts at every iteration, and denormalized points to
1e-9 — with the face angle off, and on at the default 35/160 degree
band and at 60/120; from the mesh, and from the JAX smoother's state
carried across.  Plus the relTol stop, the run loop's log lines and
writes, and what the port refuses.

Boundary point smoothing (tc7) and boundary smoothing with layers
(tc5) are held the same way, from the mesh and from the JAX state
carried across, with equal ray-miss counts too.  Their maximum step is
pinned above the raw step range: the step limiter jumps where |step|
equals it, and a second limiter call (after the layer blend or the
boundary projection) lands every limited point on that knife-edge,
where last-bit noise flips the branch.

The JAX smoothers with the face angle on are traced with
``SMOOTHMESH_FA_SLOT_SCAN=1`` (the JAX fixed point's pair slots as a
``fori_loop``, bit-identical by its own design note), which builds
~3x faster here; each is built once and shared by the tests."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smoothmesh_tpu import driver as jax_driver
from smoothmesh_tpu import testcases as jtc
from smoothmesh_tpu.driver import Smoother as JaxSmoother
from smoothmesh_tpu.mesh.blockmesh import hex_block as jax_hex
from smoothmesh_tpu.mesh.blockmesh import perturb as jax_perturb
from smoothmesh_tpu.ops import constraints as jcon
from smoothmesh_tpu.params import SmoothingParams as JaxParams
from smoothmesh_torch import testcases as ttc
from smoothmesh_torch.convert import state_from_jax
from smoothmesh_torch.driver import Smoother
from smoothmesh_torch.mesh.blockmesh import hex_block, perturb
from smoothmesh_torch.params import SmoothingParams

torch.set_num_threads(1)

ITERS = 6
#: face-angle bands (degrees) of the face-angle-on runs
BANDS = {"default": {}, "60-120": dict(min_angle=60.0, max_angle=120.0)}
CARRY_AT = 2     # iterations before the state is carried across
#: boundary smoothing alone (tc7), and with layers (tc5)
BND_CASES = ["tc7", "tc5"]
#: the boundary runs' max step: above their raw step range (see above)
BND_MAX_STEP = 0.25
#: the runs with the face angle off: ITERS iterations, and the relTol
#: stop (a max step large enough for the residual to fall within a few
#: iterations: 1.0, 1.0, 0.23, 0.12, 0.079, 0.054, 0.039, ...)
RUNS = {"plain": dict(centroidal_iters=ITERS, rel_tol=0.0),
        "rel_tol": dict(centroidal_iters=15, rel_tol=0.05,
                        max_step_length=0.05)}
#: the fatal ray-miss runs: the face angle off (it builds quicker and
#: plays no part there)
FATAL_MISS = dict(smoothing_patches=("top",), ray_miss_fatal=True,
                  face_angle_constraint=False)


def _mesh():
    return perturb(hex_block(n=(10, 8, 8)), amplitude=0.06, seed=7)


def _jax_smoother(face_angle_constraint=False, **kw):
    mesh = jax_perturb(jax_hex(n=(10, 8, 8)), amplitude=0.06, seed=7)
    return JaxSmoother(mesh, JaxParams(
        face_angle_constraint=face_angle_constraint, **kw),
        dtype=np.float64, use_tile_engine=False)


def _smoother(face_angle_constraint=False, **kw):
    return Smoother(_mesh(), SmoothingParams(
        face_angle_constraint=face_angle_constraint, **kw),
        device="cpu", dtype=torch.float64)


def _tile_form(points, cell_ctrs, proposed, td, min_angle_rad,
               max_angle_rad, frozen, **kw):
    """The JAX XLA driver's face-angle call in the form of its tile
    branch (smoothmesh_tpu/driver.py:321-327), as the port calls it: u
    space, the current angles handed in (here from the XLA per-edge
    pass, mapped to u), hence its 1e-5 u guard."""
    fc = jcon.simple_face_centres(points, td)
    cur = jcon.current_face_angles_per_point(points, cell_ctrs, td,
                                             fc_base=fc)
    u = tuple(jnp.where(a <= jnp.pi, 1.0 - jnp.cos(a), 3.0 + jnp.cos(a))
              for a in cur)
    return jcon.restrict_face_angle_deterioration(
        points, cell_ctrs, proposed, td, min_angle_rad, max_angle_rad,
        frozen, fc_base=fc, cur_minmax=u, u_space=True, **kw)


def _jax_state(sj):
    """What state_from_jax takes, read off a JAX smoother."""
    def host(d):
        return None if d is None else {
            k: v if np.isscalar(v) else np.asarray(v) for k, v in d.items()}

    return dict(
        points=np.asarray(sj.points),
        topo_arrays={f.name: getattr(sj.topo, f.name)
                     for f in dataclasses.fields(sj.topo)},
        params=dataclasses.asdict(sj.params), center=sj._center,
        scale=sj._scale, normals=np.asarray(sj.normals),
        smoothing_surface=np.asarray(sj.smoothing_surface),
        layer=host(sj.layer), bnd=host(sj.bnd))


@functools.lru_cache(maxsize=None)
def _jax_face_angle_run(band):
    """The JAX smoother with the face angle on, ITERS iterations ->
    (results, its state after CARRY_AT iterations, final points)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SMOOTHMESH_FA_SLOT_SCAN", "1")
        mp.setattr(jax_driver, "restrict_face_angle_deterioration",
                   _tile_form)
        sj = _jax_smoother(face_angle_constraint=True,
                           centroidal_iters=ITERS, rel_tol=0.0,
                           **BANDS[band])
        results = sj.steps(CARRY_AT)
        state = _jax_state(sj)
        state["denormalized"] = sj.denormalize()
        results += sj.steps(ITERS - CARRY_AT)
    return results, state, sj.denormalize()


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """The JAX smoother with the face angle off, run to its
    centroidal_iters -> (results, final points)."""
    sj = _jax_smoother(**RUNS[name])
    results = sj.steps(RUNS[name]["centroidal_iters"])
    return results, sj.denormalize()


def _half_dome():
    """The dome's target surface over x <= 0.5 only, for the 4x4x4
    block with a top patch: the rays of the top points at x = 0.5 and
    0.75 miss it -> (V, T, bpts, bedges)."""
    _, V, T, bpts, bedges = ttc.dome_geometry()
    return V, T[(V[T][..., 0] <= 0.5).all(axis=1)], bpts, bedges


@functools.lru_cache(maxsize=None)
def _jax_fatal_miss_run():
    """The JAX ``steps(2)`` under ray_miss_fatal onto the half dome:
    it raises after the first iteration -> (its iteration count, its
    points)."""
    with pytest.MonkeyPatch.context() as mp:
        # as _jax_boundary_run: the set-up's normals jitted
        mp.setattr(jax_driver.geo, "boundary_point_normals",
                   jax.jit(jax_driver.geo.boundary_point_normals))
        sj = JaxSmoother(jax_hex(n=(4, 4, 4), patches=ttc.TOP_PATCHES),
                         JaxParams(**FATAL_MISS), dtype=np.float64,
                         use_tile_engine=False)
        sj.enable_boundary_smoothing(*_half_dome())
        with pytest.raises(RuntimeError, match="surface intersection"):
            sj.steps(2)
    return sj._iteration, sj.denormalize()


def _bnd_case(testcases, name):
    """A boundary testcase and its parameters for ITERS iterations."""
    tc = testcases.ALL[name]()
    return tc, dataclasses.replace(
        tc.params, centroidal_iters=ITERS, rel_tol=0.0,
        max_step_length=BND_MAX_STEP)


@functools.lru_cache(maxsize=None)
def _jax_boundary_run(name):
    """The JAX smoother with boundary smoothing on, ITERS iterations ->
    (results, its state after CARRY_AT iterations, final points)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SMOOTHMESH_FA_SLOT_SCAN", "1")
        mp.setattr(jax_driver, "restrict_face_angle_deterioration",
                   _tile_form)
        # its set-up's normals, jitted (op by op they take seconds)
        mp.setattr(jax_driver.geo, "boundary_point_normals",
                   jax.jit(jax_driver.geo.boundary_point_normals))
        tc, params = _bnd_case(jtc, name)
        sj = JaxSmoother(tc.mesh, params, dtype=np.float64,
                         use_tile_engine=False)
        sj.enable_boundary_smoothing(*tc.geometry)
        results = sj.steps(CARRY_AT)
        state = _jax_state(sj)
        state["denormalized"] = sj.denormalize()
        results += sj.steps(ITERS - CARRY_AT)
    return results, state, sj.denormalize()


def _assert_same_run(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.iteration == w.iteration
        assert g.residual == pytest.approx(w.residual, rel=1e-9)
        assert g.n_frozen == w.n_frozen
        assert g.n_ray_miss == w.n_ray_miss


def test_smoother_matches_jax_f64():
    want, want_pts = _jax_run("plain")
    st = _smoother(**RUNS["plain"])
    assert st.points.dtype == torch.float64
    got = st.steps(ITERS)
    _assert_same_run(got, want)
    assert 0 < got[-1].n_frozen < st.topo.n_points
    moved = np.abs(st.denormalize() - _mesh().points).max()
    assert moved > 1e-3
    np.testing.assert_allclose(st.denormalize(), want_pts, rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("band", list(BANDS))
def test_smoother_face_angle_matches_jax_f64(band):
    want, _, want_pts = _jax_face_angle_run(band)
    st = _smoother(face_angle_constraint=True, centroidal_iters=ITERS,
                   rel_tol=0.0, **BANDS[band])
    got = st.steps(ITERS)
    _assert_same_run(got, want)
    # the face angle freezes internal points beyond the boundary ones
    n_bnd = int((~st.topo.is_internal_point).sum())
    assert min(r.n_frozen for r in got) > n_bnd
    np.testing.assert_allclose(st.denormalize(), want_pts, rtol=0,
                               atol=1e-9)


def test_state_from_jax_matches():
    want, state, want_pts = _jax_face_angle_run("default")
    st = state_from_jax(state["points"], state["topo_arrays"],
                        state["params"], state["center"], state["scale"],
                        device="cpu", dtype=torch.float64)
    assert st.params.face_angle_constraint
    np.testing.assert_array_equal(st.denormalize(), state["denormalized"])
    got = st.steps(ITERS - CARRY_AT)
    for g, w in zip(got, want[CARRY_AT:]):
        assert g.residual == pytest.approx(w.residual, rel=1e-9)
        assert g.n_frozen == w.n_frozen
    assert len(got) == ITERS - CARRY_AT
    np.testing.assert_allclose(st.denormalize(), want_pts, rtol=0,
                               atol=1e-9)


def test_rel_tol_stop_matches_jax():
    want, _ = _jax_run("rel_tol")
    got = _smoother(**RUNS["rel_tol"]).steps(15)
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


@pytest.mark.parametrize("name", BND_CASES)
def test_smoother_boundary_matches_jax_f64(name):
    want, _, want_pts = _jax_boundary_run(name)
    tc, params = _bnd_case(ttc, name)
    st = Smoother(tc.mesh, params, device="cpu", dtype=torch.float64)
    st.enable_boundary_smoothing(*tc.geometry)
    assert (st.layer is not None) == (name == "tc5")
    got = st.steps(ITERS)
    _assert_same_run(got, want)
    assert all(r.residual < 1.0 for r in got)   # no step at the limiter
    np.testing.assert_allclose(st.denormalize(), want_pts, rtol=0,
                               atol=1e-9)
    # the top points move towards the dome above them
    top = tc.mesh.points[:, 2] > 1 - 1e-9
    assert (st.denormalize() - tc.mesh.points)[top, 2].max() > 0.05


@pytest.mark.parametrize("name", BND_CASES)
def test_state_from_jax_boundary_matches(name):
    want, state, want_pts = _jax_boundary_run(name)
    kw = {k: state[k] for k in ("normals", "smoothing_surface", "layer",
                                "bnd")}
    st = state_from_jax(state["points"], state["topo_arrays"],
                        state["params"], state["center"], state["scale"],
                        device="cpu", dtype=torch.float64, **kw)
    assert st.bnd is not None and (st.layer is not None) == (name == "tc5")
    np.testing.assert_array_equal(st.denormalize(), state["denormalized"])
    got = st.steps(ITERS - CARRY_AT)
    assert len(got) == ITERS - CARRY_AT
    for g, w in zip(got, want[CARRY_AT:]):
        assert g.residual == pytest.approx(w.residual, rel=1e-9)
        assert g.n_frozen == w.n_frozen
        assert g.n_ray_miss == w.n_ray_miss
    np.testing.assert_allclose(st.denormalize(), want_pts, rtol=0,
                               atol=1e-9)


def test_unsupported_configurations_raise():
    """Layers and boundary smoothing run; what raises is a target
    surface that does not cover the smoothing surface, under
    ray_miss_fatal (the reference aborts there); without it the missed
    points stay frozen.  After the miss, ``step`` keeps the points and
    counts the iteration (as the JAX ``step``); ``steps`` commits the
    offending iteration and counts it, and leaves the points and the
    count of the JAX ``steps`` (one JAX smoother, float64)."""
    mesh = hex_block(n=(4, 4, 4), patches=ttc.TOP_PATCHES)
    # the reference's defaults (face angle on) construct and step
    st = Smoother(mesh, SmoothingParams(), device="cpu")
    assert st.params.face_angle_constraint
    r = st.step()
    assert r.iteration == 1 and np.isfinite(r.residual)
    # so do layers
    st = Smoother(mesh, SmoothingParams(layer_patches=("top",)),
                  device="cpu")
    assert st.layer is not None
    assert np.isfinite(st.step().residual)
    # a target surface over x <= 0.5 only: the rays of the top points
    # at x = 0.5 and 0.75 miss it
    V, half, bpts, bedges = _half_dome()
    for fatal in (True, False):
        st = Smoother(mesh, SmoothingParams(smoothing_patches=("top",),
                                            ray_miss_fatal=fatal),
                      device="cpu", dtype=torch.float64)
        st.enable_boundary_smoothing(V, half, bpts, bedges)
        before = st.denormalize()
        if fatal:
            with pytest.raises(RuntimeError, match="surface intersection"):
                st.step()
            np.testing.assert_array_equal(st.denormalize(), before)
            assert st._iteration == 1
            # steps against the JAX steps
            st = Smoother(mesh, SmoothingParams(**FATAL_MISS), device="cpu",
                          dtype=torch.float64)
            st.enable_boundary_smoothing(V, half, bpts, bedges)
            with pytest.raises(RuntimeError, match="surface intersection"):
                st.steps(2)
            jax_iteration, jax_points = _jax_fatal_miss_run()
            assert st._iteration == jax_iteration == 1
            after = st.denormalize()
            assert np.abs(after - before).max() > 1e-3     # committed
            np.testing.assert_allclose(after, jax_points, rtol=0,
                                       atol=1e-12)
            continue
        r = st.step()
        after = st.denormalize()
        top = (before[:, 2] > 1 - 1e-9) & (before[:, :2] > 0.1).all(1) \
            & (before[:, :2] < 0.9).all(1)
        missed = top & (before[:, 0] > 0.45)
        assert r.n_ray_miss == missed.sum() == 6
        np.testing.assert_array_equal(after[missed], before[missed])
        assert (after[top & ~missed, 2] > 1.0).all()   # snapped up


def test_td_keys_exact():
    """driver.TD_KEYS is exactly what one iteration of the default
    configuration reads, and TD_KEYS | NORMALS_TD_KEYS what one of the
    boundary path (layers + boundary smoothing) reads: nothing staged
    unread, nothing read unstaged."""
    from smoothmesh_torch.device import to_device
    from smoothmesh_torch.driver import (NORMALS_TD_KEYS, TD_KEYS,
                                         iteration_body)

    class Recording(dict):
        def __init__(self, *a):
            super().__init__(*a)
            self.used = set()

        def __getitem__(self, k):
            self.used.add(k)
            return dict.__getitem__(self, k)

    st = _smoother(face_angle_constraint=True, min_angle=60.0,
                   max_angle=120.0)
    assert set(st.td) == TD_KEYS
    td = Recording(to_device(st.topo, "cpu"))
    iteration_body(st.points, td, st.params, st._scale)
    assert td.used == TD_KEYS

    tc, params = _bnd_case(ttc, "tc5")
    params = dataclasses.replace(params, min_angle=80.0, max_angle=100.0)
    st = Smoother(tc.mesh, params, device="cpu", dtype=torch.float64)
    assert set(st.td) == TD_KEYS | NORMALS_TD_KEYS
    st.enable_boundary_smoothing(*tc.geometry)
    assert set(st.td) == TD_KEYS | NORMALS_TD_KEYS
    td = Recording(to_device(st.topo, "cpu"))
    iteration_body(st.points, td, st.params, st._scale,
                   normals=st.normals,
                   smoothing_surface=st.smoothing_surface, layer=st.layer,
                   bnd=st.bnd)
    assert td.used == TD_KEYS | NORMALS_TD_KEYS


def test_default_path_has_no_boundary_work():
    """Without layers or boundary smoothing an iteration runs no
    boundary stage: no smoothing-surface mask, no normals update, the
    ray-miss count the constant 0, and only the default tables
    staged."""
    from smoothmesh_torch.driver import TD_KEYS, iteration_body

    st = _smoother(face_angle_constraint=True)
    assert st.smoothing_surface is None and st.layer is None
    assert st.bnd is None and set(st.td) == TD_KEYS
    out = iteration_body(st.points, st.td, st.params, st._scale)
    assert out[1] is None and out[4] == 0 and isinstance(out[4], int)
    r = st.step()
    assert r.n_ray_miss == 0 and not st.normals.any()
    np.testing.assert_array_equal(st.points.numpy(), out[0].numpy())


def _carried(**params):
    """state_from_jax's arguments for the tc5 mesh in its own order,
    read off the port's host objects (no JAX smoother needed)."""
    from smoothmesh_torch.mesh.topology import compile_topology
    from smoothmesh_torch.quality import mesh_stats

    tc = ttc.ALL["tc5"]()
    topo = compile_topology(tc.mesh)
    stats = mesh_stats(tc.mesh.points, topo.edges)
    resolved = dataclasses.replace(tc.params, **params).resolve(
        stats.min_edge_length)
    center = tc.mesh.points.mean(axis=0)
    scale = 1.0 / stats.min_edge_length
    return tc, dict(
        points=(tc.mesh.points - center) * scale,
        topo_arrays={f.name: getattr(topo, f.name)
                     for f in dataclasses.fields(topo)},
        params=dataclasses.asdict(resolved), center=center, scale=scale,
        device="cpu", dtype=torch.float64)


@pytest.mark.parametrize("missing", ["layer", "mesh"])
def test_state_from_jax_refuses_what_it_cannot_carry(missing):
    """A carried smoother whose layer patches match but that gets no
    layer maps raises, and so does enable_boundary_smoothing on carried
    state (it has no mesh to classify): each with a message that says
    what to pass instead of failing later."""
    if missing == "layer":
        _, kw = _carried()
        with pytest.raises(ValueError, match="layer="):
            state_from_jax(**kw)
        return
    tc, kw = _carried(layer_patches=())
    sm = state_from_jax(**kw)
    assert sm.layer is None and sm.bnd is None
    with pytest.raises(RuntimeError, match="bnd="):
        sm.enable_boundary_smoothing(*tc.geometry)
