"""The port's disjoint domain decomposition (smoothmesh_torch.parallel:
partition.build_shards, sync.UnionPointSync, sharded.ShardedSmoother)
against the JAX package's (smoothmesh_tpu.parallel), on the CPU.

- The host build: build_shards array-equal to the JAX function (every
  topology table, the local points, l2g, the shared slots where they
  are valid, the owners) on the 6^3 graded mesh of tests/test_parallel.py
  and on tc5.
- Every combine of UnionPointSync against the JAX PointSync under
  shard_map on 4 CPU devices, on fields made from a numpy seed and on
  exact-tie fixtures (as tests/test_sync_tiebreak.py): the folds bit
  for bit, the sums to 1e-15 relative; is_closer_point likewise.
- ShardedSmoother(device="cpu", float64) with 3 shards against the JAX
  ShardedSmoother on 3 devices, its face-angle call held in the tile
  branch's form (as tests/test_torch_driver.py does) and its packed
  face-angle tables rebuilt from its stacked tables (its own padding
  corrupts them, see _repair_face_angle_tables), at the default
  band and at 60/120: equal frozen counts, residuals within 1e-9
  relative, denormalized points within 1e-9; from the JAX smoother's
  state carried across too; and with layers and boundary smoothing
  (tc5, freezes off, as the JAX package's own tests).  The JAX
  smoothers are built once a process, traced with
  SMOOTHMESH_FA_SLOT_SCAN=1.
- The rank-local freeze fixture of tests/test_sharded_freeze_semantics.py.
- The row-restricted predictor bit-equal to the full plain chain with
  the exchanges; batched steps bit-equal to one iteration a dispatch;
  the freeze-free run against the port's own Smoother with every
  holder of a shared point bit-identical; the quality report.
- Smoother(n_devices=) delegation by the JAX rule, the refusal without
  a card, the models registry and export_edges_as_stl.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from smoothmesh_tpu import driver as jax_driver
from smoothmesh_tpu import models as jax_models
from smoothmesh_tpu.mesh.blockmesh import hex_block as jax_hex
from smoothmesh_tpu.mesh.blockmesh import perturb as jax_perturb
from smoothmesh_tpu.ops import constraints as jcon
from smoothmesh_tpu.params import SmoothingParams as JaxParams
from smoothmesh_tpu.parallel import partition as jpart
from smoothmesh_tpu.parallel import sync as jsync
from smoothmesh_tpu.parallel.sharded import ShardedSmoother as JaxSharded
from smoothmesh_tpu.utils import export_edges_as_stl as jax_export
from smoothmesh_torch import driver, models
from smoothmesh_torch import geometry as geo
from smoothmesh_torch import testcases as ttc
from smoothmesh_torch.convert import sharded_state_from_jax
from smoothmesh_torch.device import to_device
from smoothmesh_torch.driver import Smoother
from smoothmesh_torch.mesh.blockmesh import hex_block, perturb
from smoothmesh_torch.mesh.topology import MeshTopology, compile_topology
from smoothmesh_torch.ops import smoothing as sm
from smoothmesh_torch.parallel import partition, sync
from smoothmesh_torch.parallel.halo import HaloSmoother
from smoothmesh_torch.parallel.sharded import ShardedSmoother
from smoothmesh_torch.parallel.union import union_topology
from smoothmesh_torch.params import SmoothingParams
from smoothmesh_torch.quality import QUALITY_TD_KEYS, quality_report
from smoothmesh_torch.utils import export_edges_as_stl

torch.set_num_threads(1)

ITERS = 6
CARRY_AT = 2
#: face-angle bands (degrees) of the runs against the JAX package
BANDS = {"default": {}, "60-120": dict(min_angle=60.0, max_angle=120.0)}
#: the boundary run's max step, above its raw step range (the second
#: step-limiter call's knife-edge, see tests/test_torch_driver.py)
BND_MAX_STEP = 0.25
#: no freeze: the JAX package's own sharded layer and boundary tests
FREEZE_FREE = dict(edge_angle_constraint=False, face_angle_constraint=False,
                   min_edge_length=1e-12)
_TOPO_FIELDS = [f.name for f in dataclasses.fields(MeshTopology)]


def _hex6(hb, pt):
    """tests/test_parallel.py's mesh."""
    return pt(hb(n=(6, 6, 6), grading=(2.0, 1.0, 0.5)), 0.03, seed=5)


def _parity_mesh(hb, pt):
    return pt(hb(n=(8, 6, 6)), amplitude=0.06, seed=7)


def _tile_form(points, cell_ctrs, proposed, td, min_angle_rad,
               max_angle_rad, frozen, **kw):
    """The JAX XLA face-angle call in its tile branch's form (u space,
    current angles handed in, its 1e-5 u guard), as the port calls it."""
    fc = jcon.simple_face_centres(points, td)
    cur = jcon.current_face_angles_per_point(points, cell_ctrs, td,
                                             fc_base=fc)
    u = tuple(jnp.where(a <= jnp.pi, 1.0 - jnp.cos(a), 3.0 + jnp.cos(a))
              for a in cur)
    return jcon.restrict_face_angle_deterioration(
        points, cell_ctrs, proposed, td, min_angle_rad, max_angle_rad,
        frozen, fc_base=fc, cur_minmax=u, u_space=True, **kw)


def _jax_steps(js, n):
    return [js.step() for _ in range(n)]


def _repair_face_angle_tables(js):
    """The JAX ShardedSmoother's packed face-angle tables, rebuilt as its
    ``device._fa_packed`` builds them but from the stacked (padded)
    tables.  ``build_shards`` pads each shard's packed tables after
    packing them: the padded slots of ``pps_signed``/``fps_signed``/
    ``pe_flat`` get 0 where the packing writes -1 (a valid-looking slot
    of point, face or edge 0), and ``pe_flat``'s side offset stays each
    shard's own edge count where the fixed point reads the stacked one.
    Where the face-angle band bites, that moves the JAX class's freezes
    off its own per-shard semantics, which the port keeps."""
    st = js.shards.stacked
    E = st["edges"].shape[1]
    wf = st["edge_faces"].shape[2]
    sb = max(wf, 1).bit_length()
    tables = {
        "pps_signed": np.where(st["point_points_mask"], st["point_points"],
                               -1),
        "fps_signed": np.where(st["face_mask"], st["face_points"], -1),
        "pe_flat": np.where(st["point_edges_mask"],
                            st["point_edges_side"].astype(np.int64) * E
                            + st["point_edges"], -1),
        "ecf_packed": (st["edge_cell_f0"].astype(np.int64)
                       + (st["edge_cell_f1"].astype(np.int64) << sb)
                       + (st["edge_cells_mask"].astype(np.int64)
                          << (2 * sb)))}
    shard0 = NamedSharding(js.jmesh, P("shard"))
    wrong = 0
    for k, v in tables.items():
        wrong += int((np.asarray(js.td[k]) != v).sum())
        js.td[k] = jax.device_put(jnp.asarray(v.astype(np.int32)), shard0)
    return wrong


@functools.lru_cache(maxsize=None)
def _jax_sharded_run(band):
    """The JAX ShardedSmoother (3 devices, float64, its face-angle tables
    repaired) for ITERS iterations -> (results, its state after
    CARRY_AT, final points)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SMOOTHMESH_FA_SLOT_SCAN", "1")
        mp.setattr(jax_driver, "restrict_face_angle_deterioration",
                   _tile_form)
        js = JaxSharded(_parity_mesh(jax_hex, jax_perturb), JaxParams(
            centroidal_iters=ITERS, rel_tol=0.0, **BANDS[band]),
            devices=jax.devices()[:3], dtype=np.float64)
        assert _repair_face_angle_tables(js) > 0
        results = _jax_steps(js, CARRY_AT)
        state = dict(points=np.asarray(js.points),
                     normals=np.asarray(js.normals),
                     params=dataclasses.asdict(js.params),
                     center=js._center, scale=js._scale,
                     denormalized=js.denormalize())
        results += _jax_steps(js, ITERS - CARRY_AT)
    return results, state, js.denormalize()


def _assert_same_run(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.iteration == w.iteration
        assert g.residual == pytest.approx(w.residual, rel=1e-9)
        assert g.n_frozen == w.n_frozen
        assert g.n_ray_miss == w.n_ray_miss


def _sharded(mesh, params, n_shards=3, dtype=torch.float64):
    return ShardedSmoother(mesh, params, n_shards=n_shards, device="cpu",
                           dtype=dtype)


# -- the host build ----------------------------------------------------------

BUILDS = {"hex6-3": ("hex6", 3), "hex6-4": ("hex6", 4), "tc5-3": ("tc5", 3)}


def _build_mesh(name, port: bool):
    if name == "tc5":
        return ttc.ALL["tc5"]().mesh
    return _hex6(*((hex_block, perturb) if port else (jax_hex, jax_perturb)))


@pytest.mark.parametrize("name", list(BUILDS))
def test_build_shards_matches_jax(name):
    mesh, d = BUILDS[name]
    got = partition.build_shards(_build_mesh(mesh, True), d)
    want = jpart.build_shards(_build_mesh(mesh, False), d)
    assert got.n_shards == want.n_shards == d
    for g, w in zip(got.topos, want.topos):
        for f in _TOPO_FIELDS:
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f),
                                          err_msg=f)
    for k in ("local_points", "n_local_points", "shared_valid",
              "shared_owner_is_me", "point_owner_shard",
              "point_owner_local"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    for g, w in zip(got.local_to_global, want.local_to_global):
        np.testing.assert_array_equal(g, w)
    v = got.shared_valid
    assert v.sum(0).min() >= 2
    np.testing.assert_array_equal(got.shared_slot_local[v],
                                  want.shared_slot_local[v])
    assert (got.shared_slot_local[~v] == got.n_padded_points).all()
    assert got.n_padded_points == want.n_padded_points


# -- the combines against the JAX PointSync ----------------------------------

D_SYNC = 4


@functools.lru_cache(maxsize=None)
def _sync_setup():
    sh = partition.build_shards(_hex6(hex_block, perturb), D_SYNC)
    un = union_topology(sh)
    t = torch.from_numpy
    us = sync.UnionPointSync(t(un.pair_rows), t(un.pair_slots),
                             t(un.pair_shard), t(un.pair_owner), D_SYNC,
                             un.n_slots)
    return sh, un, us


def _jax_sync(op, sh, *blocks):
    """``op(PointSync, *fields)`` on each shard under shard_map -> the
    (D, ...) per-shard results."""
    jmesh = Mesh(np.array(jax.devices()[:D_SYNC]), ("shard",))

    def body(slot, valid, own, *f):
        s = jsync.PointSync(slot[0], valid[0], own[0], axis="shard")
        out = op(s, *(x[0] for x in f))
        return jax.tree.map(lambda y: y[None], out)

    fn = jax.jit(jax.shard_map(
        body, mesh=jmesh, in_specs=(P("shard"),) * (3 + len(blocks)),
        out_specs=P("shard"), check_vma=False))
    out = fn(jnp.asarray(sh.shared_slot_local, dtype=jnp.int32),
             jnp.asarray(sh.shared_valid),
             jnp.asarray(sh.shared_owner_is_me),
             *(jnp.asarray(b) for b in blocks))
    return jax.tree.map(np.asarray, out)


def _fields(kind, shape, rng):
    """(D, Npad, *shape) blocks: normal floats, or small multiples of 0.5
    whose squared magnitudes sum exactly in any order (ties)."""
    full = (D_SYNC,) + shape
    if kind == "ties":
        return rng.integers(-2, 3, size=full).astype(np.float64) * 0.5
    return rng.normal(size=full)


def _ties_everywhere(sh, c):
    """Each holder of a shared point takes a permutation or sign flip of
    one base vector: equal magnitudes, different coordinates."""
    c = c.copy()
    base = np.random.default_rng(5).integers(-2, 3, size=(
        sh.shared_valid.shape[1], 3)).astype(np.float64) * 0.5
    for d in range(D_SYNC):
        s = np.where(sh.shared_valid[d])[0]
        v = base[s][:, np.random.default_rng(d).permutation(3)]
        c[d, sh.shared_slot_local[d, s]] = v * np.where(d % 2, -1.0, 1.0)
    return c


def _port_field(un, blocks):
    return torch.from_numpy(np.ascontiguousarray(un.rows(blocks)))


OPS = ["sum3", "sum1", "sum_int", "or", "max", "min_mag_sqr",
       "min_mag_sqr_ties", "max_mag_sqr", "max_mag_sqr_ties", "consensus",
       "closest_points", "closest_points_ties"]


@pytest.mark.parametrize("op", OPS)
def test_point_sync_matches_jax(op):
    sh, un, us = _sync_setup()
    rng = np.random.default_rng(OPS.index(op))
    npad = sh.n_padded_points
    ties = op.endswith("_ties")
    name = op[:-5] if ties else op
    if name == "closest_points":
        cs = [_fields("ties" if ties else "normal", (npad, 3), rng)
              for _ in range(3)]
        if ties:
            cs = [_ties_everywhere(sh, c) for c in cs]
        hc = rng.random((D_SYNC, npad)) < 0.5
        want = _jax_sync(lambda s, *f: s.closest_points(*f), sh, *cs, hc)
        got = us.closest_points(*(_port_field(un, b) for b in cs + [hc]))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), un.rows(w))
        if ties:   # the cascade takes other holders' candidates
            assert not np.array_equal(got[0].numpy(), un.rows(cs[0]))
        return
    shape = {"sum1": (npad,), "sum_int": (npad,), "or": (npad,),
             "max": (npad,)}.get(name, (npad, 3))
    if name == "sum_int":
        f = rng.integers(0, 7, size=(D_SYNC,) + shape)
    elif name == "or":
        f = rng.random((D_SYNC,) + shape) < 0.3
    else:
        f = _fields("ties" if ties else "normal", shape, rng)
        if ties:
            f = _ties_everywhere(sh, f)
    call = {"sum3": "sum", "sum1": "sum", "sum_int": "sum",
            "or": "or_"}.get(name, name)
    if name == "max":
        want = _jax_sync(lambda s, x: s.max(x, -1.0), sh, f)
        got = us.max(_port_field(un, f), -1.0)
    else:
        want = _jax_sync(lambda s, x: getattr(s, call)(x), sh, f)
        got = getattr(us, call)(_port_field(un, f))
    w = un.rows(want)
    if name.startswith("sum") and f.dtype == np.float64:
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-15,
                                   atol=1e-15 * np.abs(w).max())
    else:
        np.testing.assert_array_equal(got.numpy(), w)
    assert not np.array_equal(got.numpy(), un.rows(f))   # not vacuous


def test_point_sync_all_reduces_match_jax():
    sh, un, us = _sync_setup()
    f = np.random.default_rng(9).normal(size=(D_SYNC, sh.n_padded_points))
    live = np.zeros(f.shape, dtype=bool)
    for d, n in enumerate(sh.n_local_points):
        live[d, :n] = True
    f = np.where(live, f, 0.0)
    for name, red in (("all_max", "max"), ("all_min", "min"),
                      ("all_sum", "sum")):
        want = _jax_sync(
            lambda s, x, r=red, n=name: getattr(s, n)(getattr(jnp, r)(x)),
            sh, f)
        got = getattr(us, name)(getattr(torch, red)(_port_field(un, f)))
        assert float(got) == pytest.approx(float(want[0]), rel=1e-15)


def test_is_closer_point_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.integers(-2, 3, size=(400, 3)).astype(np.float64)
    b = a[:, rng.permutation(3)] * rng.choice([-1.0, 1.0], size=(400, 1))
    c = rng.normal(size=(400, 3))
    for p1, p2 in ((a, b), (b, a), (a, c), (c, a), (a, a)):
        for dt in (np.float64, np.float32):
            x, y = p1.astype(dt), p2.astype(dt)
            want = np.asarray(jsync.is_closer_point(jnp.asarray(x),
                                                    jnp.asarray(y)))
            got = sync.is_closer_point(torch.from_numpy(x),
                                       torch.from_numpy(y)).numpy()
            np.testing.assert_array_equal(got, want)
    want = np.asarray(jsync.is_smaller_by_vector_elements(
        jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(sync.is_smaller_by_vector_elements(
        torch.from_numpy(a), torch.from_numpy(b)).numpy(), want)
    # denormal points that differ are closer both ways (their magnitudes
    # tie), as in the reference's double arithmetic; XLA's CPU backend
    # flushes them to zero, so the JAX function is not asked
    tiny = torch.tensor([[1e-310, 0.0, 0.0], [0.0, 1e-310, 0.0]],
                        dtype=torch.float64)
    assert sync.is_closer_point(tiny, tiny.flip(0)).tolist() == [True, True]
    assert sync.is_closer_point(tiny, tiny).tolist() == [False, False]


def test_union_point_sync_writes_plus_zero():
    """A -0.0 arrives as +0.0 on every holder (as a psum and the ranks'
    all_reduce write it)."""
    sh, un, us = _sync_setup()
    f = torch.zeros((un.topo.n_points, 3), dtype=torch.float64)
    f[us.rows] = -0.0
    for out in (us.sum(f), us.consensus(f), us.min_mag_sqr(f)):
        assert not torch.signbit(out[us.rows]).any()


# -- against the JAX ShardedSmoother ------------------------------------------

def _port_params(band, **kw):
    return SmoothingParams(centroidal_iters=ITERS, rel_tol=0.0,
                           **BANDS[band], **kw)


@pytest.mark.parametrize("band", list(BANDS))
def test_sharded_matches_jax_f64(band):
    want, _, want_pts = _jax_sharded_run(band)
    ss = _sharded(_parity_mesh(hex_block, perturb), _port_params(band))
    got = ss.steps(ITERS)
    _assert_same_run(got, want)
    # 60/120 freezes internal points beyond the boundary ones
    n_bnd = int((~ss.topo.is_internal_point).sum())
    assert min(r.n_frozen for r in got) > n_bnd or band == "default"
    np.testing.assert_allclose(ss.denormalize(), want_pts, rtol=0,
                               atol=1e-9)


def test_sharded_state_from_jax_matches():
    want, state, want_pts = _jax_sharded_run("60-120")
    ss = sharded_state_from_jax(
        _parity_mesh(hex_block, perturb), 3, state["points"],
        state["params"], state["center"], state["scale"], device="cpu",
        dtype=torch.float64, normals=state["normals"])
    assert isinstance(ss, ShardedSmoother) and ss.params.min_angle == 60.0
    np.testing.assert_array_equal(ss.denormalize(), state["denormalized"])
    for d, n in enumerate(ss.shards.n_local_points):   # the live rows
        np.testing.assert_array_equal(ss.shard_points()[d, :n],
                                      state["points"][d, :n])
    got = ss.steps(ITERS - CARRY_AT)
    assert len(got) == ITERS - CARRY_AT
    for g, w in zip(got, want[CARRY_AT:]):
        assert g.residual == pytest.approx(w.residual, rel=1e-9)
        assert g.n_frozen == w.n_frozen
    np.testing.assert_allclose(ss.denormalize(), want_pts, rtol=0,
                               atol=1e-9)


def test_sharded_layers_and_boundary_match_jax():
    """tc5 (layers on, boundary smoothing onto its target surface),
    freezes off as in the JAX package's own sharded tests."""
    tc = ttc.ALL["tc5"]()
    params = dataclasses.replace(tc.params, centroidal_iters=4,
                                 rel_tol=0.0, max_step_length=BND_MAX_STEP,
                                 **FREEZE_FREE)
    js = JaxSharded(tc.mesh, JaxParams(**dataclasses.asdict(params)),
                    devices=jax.devices()[:3], dtype=np.float64)
    js.enable_boundary_smoothing(*tc.geometry)
    want = _jax_steps(js, 4)
    ss = _sharded(tc.mesh, params)
    setup = ss.enable_boundary_smoothing(*tc.geometry)
    assert ss.layer is not None and ss.bnd is not None
    np.testing.assert_array_equal(setup.is_corner,
                                  js.boundary_setup.is_corner)
    got = ss.steps(4)
    _assert_same_run(got, want)
    np.testing.assert_allclose(ss.denormalize(), js.denormalize(), rtol=0,
                               atol=1e-9)
    top = tc.mesh.points[:, 2] > 1 - 1e-9
    assert np.abs(ss.denormalize() - tc.mesh.points)[top].max() > 1e-3


def test_rank_local_freeze_semantics():
    """tests/test_sharded_freeze_semantics.py's fixture: the mid point
    p = (2, 1, 1) freezes on shard 0's local edges (a long left edge
    shortens below the minimum), which the single device, seeing the
    short right edge, does not; OR-combined, the port's 2 shards freeze
    it, as the reference's ranks (and the JAX class) do."""
    m = hex_block(p_min=(0, 0, 0), p_max=(4, 2, 2), n=(4, 2, 2))
    pts = m.points.copy()
    pts[:, 0] = np.where(np.isclose(pts[:, 0], 3.0), 2.3, pts[:, 0])
    pts[:, 0] = np.where(np.isclose(pts[:, 0], 4.0), 2.6, pts[:, 0])
    m.points = pts
    params = SmoothingParams(centroidal_iters=1, rel_tol=0.0,
                             min_edge_length=0.95,
                             edge_angle_constraint=False,
                             face_angle_constraint=False)
    p = int(np.where(np.all(np.isclose(pts, [2.0, 1.0, 1.0]), axis=1))[0][0])
    single = Smoother(m, params, device="cpu", dtype=torch.float64)
    single.steps(1)
    s_pts = single.denormalize()
    assert s_pts[p, 0] < 2.0 - 0.05
    ss = _sharded(m, params, n_shards=2)
    ss.steps(1)
    h_pts = ss.denormalize()
    assert abs(h_pts[p, 0] - 2.0) < 1e-9
    rest = np.arange(len(pts)) != p
    assert np.abs(s_pts[rest] - h_pts[rest]).max() < 1e-9


# -- the port's own checks ------------------------------------------------------

@pytest.mark.parametrize("do_boundary", [False, True])
def test_predict_shared_rows_equals_the_full_chain(do_boundary):
    """K3's plain version on every row with the shared rows recomputed
    (the driver's disjoint path) equals the full plain chain with the
    exchanges, bit for bit in float64; the shared rows do change."""
    ss = _sharded(_hex6(hex_block, perturb), SmoothingParams(
        centroidal_iters=2, rel_tol=0.0), n_shards=4)
    ss.steps(2)
    td, pts = ss.td, ss.points
    fg = geo.face_centres_areas(pts, td["face_points"], td["face_mask"],
                                td["face_npoints"])
    cc, _ = geo.cell_centres_vols(fg, td)
    args = (pts, cc, td, 0.3, 0.5, do_boundary)
    alone, _ = sm.predictor_plain(*args)
    full, _ = sm.predictor_plain(*args, sync=ss.sync)
    got = sm.predict_shared_rows(alone, *args, ss.sync)
    assert torch.equal(got, full)
    rows = ss.sync.rows
    assert not torch.equal(alone[rows], full[rows])
    keep = torch.ones(len(pts), dtype=torch.bool)
    keep[rows] = False
    assert torch.equal(alone[keep], full[keep])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sharded_batched_matches_one_by_one(dtype, monkeypatch):
    """In batches of 4 through a face-angle stop (60/120 bites at the
    first iteration) and one iteration a dispatch: bit-equal."""
    monkeypatch.setenv("SMOOTHMESH_ITER_BATCH", "4")
    mesh, params = _parity_mesh(hex_block, perturb), _port_params("60-120")
    a, b = _sharded(mesh, params, dtype=dtype), _sharded(mesh, params,
                                                         dtype=dtype)
    assert a.iter_batch == 4
    b.iter_batch = 1
    ra, rb = a.steps(ITERS), b.steps(ITERS)
    assert a.face_angle_stops >= 1
    assert [(r.iteration, r.residual, r.n_frozen) for r in ra] == \
        [(r.iteration, r.residual, r.n_frozen) for r in rb]
    assert torch.equal(a.points, b.points)


def test_sharded_freeze_free_matches_single_device():
    """With the freezes off the decomposition is the single device's
    smoothing to rounding (4 shards), and every holder of a shared
    point holds the same bits."""
    mesh = _hex6(hex_block, perturb)
    params = SmoothingParams(centroidal_iters=8, rel_tol=0.0,
                             max_step_length=0.01, **FREEZE_FREE)
    s = Smoother(mesh, params, device="cpu", dtype=torch.float64)
    rs = s.steps(8)
    assert np.abs(s.denormalize() - mesh.points).max() > 0.01
    ss = _sharded(mesh, params, n_shards=4)
    rh = ss.steps(8)
    for a, b in zip(rs, rh):
        assert b.residual == pytest.approx(a.residual, rel=1e-12)
    np.testing.assert_allclose(ss.denormalize(), s.denormalize(), rtol=0,
                               atol=1e-12)
    un, pts = ss.union, ss.points
    for slot in range(un.n_slots):
        r = torch.from_numpy(un.pair_rows[un.pair_slots == slot])
        assert len(r) >= 2 and (pts[r] == pts[r[0]]).all()


def test_sharded_quality_is_the_global_report():
    ss = _sharded(_parity_mesh(hex_block, perturb), _port_params("default"))
    ss.steps(2)
    q = ss.quality()
    q0 = quality_report(torch.from_numpy(ss.denormalize()),
                        to_device(compile_topology(ss.mesh), "cpu",
                                  QUALITY_TD_KEYS))
    assert set(q) == set(q0)
    for k, v in q0.items():
        if isinstance(v, int):
            assert q[k] == v, k
        else:
            assert q[k] == pytest.approx(v, rel=1e-9, abs=1e-12), k


def test_smoother_n_devices_delegates(monkeypatch):
    mesh, params = _hex6(hex_block, perturb), SmoothingParams()
    kw = dict(device="cpu", dtype=torch.float64)
    assert type(Smoother(mesh, params, n_devices=1, **kw)) is Smoother
    s3 = Smoother(mesh, params, n_devices=3, **kw)
    assert type(s3) is ShardedSmoother and s3.shards.n_shards == 3
    h3 = Smoother(mesh, params, n_devices=3, use_tile_engine=True, **kw)
    assert type(h3) is HaloSmoother and h3.shards.n_shards == 3
    # on the card in float32 the rule takes the halo, else the disjoint
    made = []
    for mod, name in (("halo", "HaloSmoother"),
                      ("sharded", "ShardedSmoother")):
        monkeypatch.setattr(
            f"smoothmesh_torch.parallel.{mod}.{name}",
            lambda *a, _n=name, **k: made.append((_n, k["dtype"])))
    monkeypatch.setattr(driver, "resolve_device",
                        lambda d: torch.device("cuda"))
    Smoother(mesh, params, n_devices=2)
    Smoother(mesh, params, n_devices=2, dtype=torch.float32)
    Smoother(mesh, params, n_devices=2, dtype=torch.float64)
    Smoother(mesh, params, n_devices=2, use_tile_engine=False)
    assert made == [("HaloSmoother", None), ("HaloSmoother", torch.float32),
                    ("ShardedSmoother", torch.float64),
                    ("ShardedSmoother", None)]


def test_n_devices_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"use_tile_engine": False}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Smoother(_hex6(hex_block, perturb), SmoothingParams(),
                     n_devices=3, **kw)


def test_models_registry():
    assert set(models.REGISTRY) == set(jax_models.REGISTRY)
    assert models.get_model("smoother") is Smoother
    assert models.get_model("sharded") is ShardedSmoother


def test_export_edges_as_stl_matches_jax(tmp_path):
    tc = ttc.ALL["tc5"]()
    topo = compile_topology(tc.mesh)
    pp = np.where(topo.point_points_mask[:, 0], topo.point_points[:, 0], -1)
    pp[::3] = -1
    got, want = tmp_path / "port.stl", tmp_path / "jax.stl"
    n = export_edges_as_stl(str(got), tc.mesh.points, pp)
    assert n == jax_export(str(want), tc.mesh.points, pp) == (pp >= 0).sum()
    assert got.read_bytes() == want.read_bytes()
