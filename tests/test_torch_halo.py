"""The port's halo decomposition (smoothmesh_torch.parallel) against the
JAX package's (smoothmesh_tpu.parallel) and against its own
single-device Smoother, on the CPU.

- The host build: partition_cells and build_halo_shards array-equal to
  the JAX functions (every topology table, the owned masks, l2g, the
  claims, the shared slots where they are valid, the edge-length
  extremes), to_device on a padded topology, and the scatter of tc5's
  layer maps and tc7's boundary set-up.
- HaloSmoother(device="cpu", float64) with 3 shards against the JAX
  HaloSmoother(n_devices=3, use_tile_engine=False), its face-angle call
  held in the tile branch's form (as tests/test_torch_driver.py does),
  at the default band and at 60/120: equal frozen counts, residuals
  within 1e-9 relative, denormalized points within 1e-9; and from the
  JAX smoother's state carried across.  The two JAX smoothers are built
  once, traced with SMOOTHMESH_FA_SLOT_SCAN=1.
- Against the port's single-device Smoother: 8 shards on the 10^3
  stress mesh (min angle 15, equal frozen counts), tc5 (layers and
  boundary smoothing) and tc7 (boundary smoothing).
- Batched steps bit-equal to one iteration a dispatch, through a
  face-angle stop; quality() against the global report.
- Smoother(normalize=False) and the step limiter's global scaling
  against the JAX functions.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from smoothmesh_tpu import driver as jax_driver
from smoothmesh_tpu.device import to_device as jax_to_device
from smoothmesh_tpu.driver import Smoother as JaxSmoother
from smoothmesh_tpu.mesh.blockmesh import hex_block as jax_hex
from smoothmesh_tpu.mesh.blockmesh import perturb as jax_perturb
from smoothmesh_tpu.mesh.blockmesh import prism_block as jax_prism
from smoothmesh_tpu.ops import constraints as jcon
from smoothmesh_tpu.ops import smoothing as jsm
from smoothmesh_tpu.params import SmoothingParams as JaxParams
from smoothmesh_tpu.parallel import halo as jhalo
from smoothmesh_tpu.parallel import partition as jpart
from smoothmesh_tpu.parallel import scatter as jscatter
from smoothmesh_tpu.parallel.halo import HaloSmoother as JaxHalo
from smoothmesh_torch import layers as lay
from smoothmesh_torch import testcases as ttc
from smoothmesh_torch.boundary import classify_boundary_points
from smoothmesh_torch.convert import halo_state_from_jax
from smoothmesh_torch.device import to_device
from smoothmesh_torch.driver import Smoother, StepResult
from smoothmesh_torch.mesh.blockmesh import hex_block, perturb, prism_block
from smoothmesh_torch.mesh.topology import MeshTopology, compile_topology
from smoothmesh_torch.ops import smoothing as sm
from smoothmesh_torch.parallel import halo, partition, scatter
from smoothmesh_torch.parallel.halo import HaloSmoother
from smoothmesh_torch.parallel.ranks import Job, run_ranks
from smoothmesh_torch.parallel.sync import UnionSync
from smoothmesh_torch.params import SmoothingParams
from smoothmesh_torch.quality import (QUALITY_TD_KEYS, mesh_stats,
                                      quality_report)

torch.set_num_threads(1)

ITERS = 6
CARRY_AT = 2
#: face-angle bands (degrees) of the runs against the JAX package
BANDS = {"default": {}, "60-120": dict(min_angle=60.0, max_angle=120.0)}
#: the boundary runs' max step, above their raw step range (the second
#: step-limiter call's knife-edge, see tests/test_torch_driver.py)
BND_MAX_STEP = 0.25
_TOPO_FIELDS = [f.name for f in dataclasses.fields(MeshTopology)]


def _hex6(mod):
    return mod.perturb(mod.hex_block(n=(6, 6, 6), grading=(2.0, 1.0, 0.5)),
                       amplitude=0.02, seed=3)


def _stress10(mod):
    """The heavily distorted 10^3 mesh of tests/test_halo.py's 8-shard
    case."""
    base = mod.hex_block(n=(10, 10, 10), grading=(2.0, 1.0, 0.5))
    ms = min(np.diff(np.unique(base.points[:, a])).min() for a in range(3))
    return mod.perturb(base, amplitude=0.45 * ms, seed=3)


class _Mods:
    def __init__(self, hb, pt):
        self.hex_block, self.perturb = hb, pt


PORT, JAX = _Mods(hex_block, perturb), _Mods(jax_hex, jax_perturb)
#: (mesh, shards) of the host-build comparisons
BUILDS = {"hex6-2": (_hex6, 2), "hex6-4": (_hex6, 4),
          "stress10-8": (_stress10, 8)}


def _parity_mesh(mod):
    return mod.perturb(mod.hex_block(n=(8, 6, 6)), amplitude=0.06, seed=7)


def _tile_form(points, cell_ctrs, proposed, td, min_angle_rad,
               max_angle_rad, frozen, **kw):
    """The JAX XLA face-angle call in its tile branch's form (u space,
    current angles handed in, its 1e-5 u guard), as the port calls it;
    ``**kw`` forwards ``eligible`` (the owned points)."""
    fc = jcon.simple_face_centres(points, td)
    cur = jcon.current_face_angles_per_point(points, cell_ctrs, td,
                                             fc_base=fc)
    u = tuple(jnp.where(a <= jnp.pi, 1.0 - jnp.cos(a), 3.0 + jnp.cos(a))
              for a in cur)
    return jcon.restrict_face_angle_deterioration(
        points, cell_ctrs, proposed, td, min_angle_rad, max_angle_rad,
        frozen, fc_base=fc, cur_minmax=u, u_space=True, **kw)


@functools.lru_cache(maxsize=None)
def _jax_halo_run(band):
    """The JAX halo smoother (3 shards, float64, engine-less) for ITERS
    iterations -> (results, its state after CARRY_AT, final points)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SMOOTHMESH_FA_SLOT_SCAN", "1")
        mp.setattr(jax_driver, "restrict_face_angle_deterioration",
                   _tile_form)
        hs = JaxHalo(_parity_mesh(JAX), JaxParams(
            centroidal_iters=ITERS, rel_tol=0.0, **BANDS[band]),
            n_devices=3, dtype=np.float64, use_tile_engine=False)
        results = hs.steps(CARRY_AT)
        state = dict(points=np.asarray(hs.points),
                     normals=np.asarray(hs.normals),
                     params=dataclasses.asdict(hs.params),
                     center=hs._center, scale=hs._scale,
                     denormalized=hs.denormalize())
        results += hs.steps(ITERS - CARRY_AT)
    return results, state, hs.denormalize()


def _assert_same_run(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.iteration == w.iteration
        assert g.residual == pytest.approx(w.residual, rel=1e-9)
        assert g.n_frozen == w.n_frozen
        assert g.n_ray_miss == w.n_ray_miss


# -- the host build ----------------------------------------------------------

@pytest.mark.parametrize("name", list(BUILDS))
def test_partition_cells_matches_jax(name):
    make, d = BUILDS[name]
    np.testing.assert_array_equal(
        partition.partition_cells(make(PORT), d),
        jpart.partition_cells(make(JAX), d))
    np.testing.assert_array_equal(
        partition.cell_centroids_rough(make(PORT)),
        jpart.cell_centroids_rough(make(JAX)))


@pytest.mark.parametrize("name", list(BUILDS))
def test_build_halo_shards_matches_jax(name):
    make, d = BUILDS[name]
    got = halo.build_halo_shards(make(PORT), d)
    want = jhalo.build_halo_shards(make(JAX), d)
    assert got.n_shards == want.n_shards == d
    for g, w in zip(got.topos, want.topos):
        for f in _TOPO_FIELDS:
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f),
                                          err_msg=f)
        for rows in ("point_valid_rows", "edge_valid_rows",
                     "cell_valid_rows"):
            np.testing.assert_array_equal(getattr(g, rows),
                                          getattr(w, rows))
    for k in ("local_points", "owned", "shared_valid", "shared_owner_is_me",
              "point_owner_shard", "point_owner_local", "claim_face",
              "claim_edge", "claim_cell"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    for g, w in zip(got.l2g, want.l2g):
        np.testing.assert_array_equal(g, w)
    v = got.shared_valid
    np.testing.assert_array_equal(got.shared_slot_local[v],
                                  want.shared_slot_local[v])
    assert (got.shared_slot_local[~v] == got.oob).all()
    assert got.min_edge_length == want.min_edge_length
    assert got.max_edge_length == want.max_edge_length


def test_internal_points_come_from_the_global_mesh():
    """A shard's own compile sees its procBoundary faces as boundary;
    the shards and the union take is_internal_point from the global
    mesh instead, else every point on a cut would be held fixed."""
    mesh = _hex6(PORT)
    sh = halo.build_halo_shards(mesh, 4)
    glob = compile_topology(mesh).is_internal_point
    un = halo.union_topology(sh)
    np.testing.assert_array_equal(un.topo.is_internal_point, glob[un.l2g])
    local_view = ~un.topo.is_internal_point.copy()
    for i, t in enumerate(sh.topos):
        proc = (t.face_patch >= 0) & (
            np.array(t.patch_types)[t.face_patch] == "processor")
        on_cut = np.unique(t.face_points[proc][t.face_mask[proc]])
        assert len(on_cut) and t.is_internal_point[on_cut].any()
        local_view[un.base[i, 0] + on_cut] = True
    assert local_view.sum() > (~un.topo.is_internal_point).sum()


def test_to_device_on_a_padded_topology():
    mesh = _hex6(PORT)
    sh = halo.build_halo_shards(mesh, 2)
    jsh = jhalo.build_halo_shards(_hex6(JAX), 2)
    for t, jt in zip(sh.topos, jsh.topos):
        td = to_device(t, "cpu")
        jtd = jax_to_device(jt)
        for k, v in td.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(jtd[k]),
                                          err_msg=k)
        n = int(t.point_valid_rows.sum())
        assert n < t.n_points and td["point_valid"][:n].all()
        assert not td["point_valid"][n:].any()
        assert not td["edge_valid"][int(t.edge_valid_rows.sum()):].any()
        assert not td["cell_valid"][int(t.cell_valid_rows.sum()):].any()


def _tc_global(name):
    tc = ttc.ALL[name]()
    topo = compile_topology(tc.mesh)
    params = tc.params.resolve(
        mesh_stats(tc.mesh.points, topo.edges).min_edge_length)
    bn, sharp = lay.boundary_point_normals_np(tc.mesh.points, topo)
    maps = lay.build_layer_maps(
        topo, bn, sharp, topo.patch_ids_matching(params.layer_patches),
        topo.patch_ids_matching(params.smoothing_patches),
        params.max_layers)
    return tc, params, topo, maps


def test_scatter_layer_maps_match_jax():
    tc, _, _, maps = _tc_global("tc5")
    sh = halo.build_halo_shards(tc.mesh, 3)
    g2ls = scatter.g2l_maps(sh.l2g, tc.mesh.n_points)
    got = scatter.scatter_layer_maps(maps, sh.l2g, g2ls, sh.n_padded_points)
    want = jscatter.scatter_layer_maps(maps, sh.l2g, g2ls,
                                       sh.n_padded_points)
    assert (got[0]["outer_map"] >= 0).any()
    for k in got[0]:
        np.testing.assert_array_equal(got[0][k], want[0][k])
    np.testing.assert_array_equal(got[1], want[1])


def test_scatter_boundary_setup_matches_jax():
    tc, params, topo, maps = _tc_global("tc7")
    setup = classify_boundary_points(
        topo, *tc.geometry[2:4], *tc.geometry[2:4], *tc.geometry[:2],
        topo.patch_ids_matching(params.layer_patches),
        topo.patch_ids_matching(params.smoothing_patches),
        tc.mesh.points, params.distance_tolerance)
    sh = halo.build_halo_shards(tc.mesh, 4)
    g2ls = scatter.g2l_maps(sh.l2g, tc.mesh.n_points)

    def t(x):
        return (np.asarray(x, dtype=np.float64) - 0.5) * 3.0

    args = (setup, maps, sh.l2g, g2ls, sh.topos, sh.n_padded_points, t, 3.0)
    got, want = scatter.scatter_boundary_setup(*args), \
        jscatter.scatter_boundary_setup(*args)
    assert got[0]["feat_neigh_mask"].any() and got[0]["is_corner"].any()
    # the port builds no padded compaction rows nor the triangle count
    # (the halo smoother takes its rows from the union)
    for k in ("surf_rows", "feat_rows"):
        del want[0][k]
    del want[2]["n_tri"]
    for g, w in zip(got[:2], want[:2]):
        assert set(g) == set(w)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert got[2] == want[2]


# -- against the JAX HaloSmoother --------------------------------------------

def _halo(band, **kw):
    return HaloSmoother(_parity_mesh(PORT), SmoothingParams(
        centroidal_iters=ITERS, rel_tol=0.0, **BANDS[band]), n_shards=3,
        device="cpu", dtype=torch.float64, **kw)


@pytest.mark.parametrize("band", list(BANDS))
def test_halo_matches_jax_f64(band):
    want, _, want_pts = _jax_halo_run(band)
    hs = _halo(band)
    got = hs.steps(ITERS)
    _assert_same_run(got, want)
    n_bnd = int((~hs.topo.is_internal_point & hs.owned.numpy()).sum())
    # 60/120 freezes internal points beyond the boundary ones
    assert min(r.n_frozen for r in got) > n_bnd or band == "default"
    np.testing.assert_allclose(hs.denormalize(), want_pts, rtol=0,
                               atol=1e-9)


def test_halo_state_from_jax_matches():
    want, state, want_pts = _jax_halo_run("60-120")
    hs = halo_state_from_jax(_parity_mesh(PORT), 3, state["points"],
                             state["params"], state["center"],
                             state["scale"], device="cpu",
                             dtype=torch.float64, normals=state["normals"])
    assert hs.params.min_angle == 60.0
    np.testing.assert_array_equal(hs.denormalize(), state["denormalized"])
    for d, n in enumerate(hs.shards.n_local[:, 0]):   # the live rows
        np.testing.assert_array_equal(hs.shard_points()[d, :n],
                                      state["points"][d, :n])
    got = hs.steps(ITERS - CARRY_AT)
    assert len(got) == ITERS - CARRY_AT
    for g, w in zip(got, want[CARRY_AT:]):
        assert g.residual == pytest.approx(w.residual, rel=1e-9)
        assert g.n_frozen == w.n_frozen
    np.testing.assert_allclose(hs.denormalize(), want_pts, rtol=0,
                               atol=1e-9)


def test_halo_ranks_match_jax_f64(tmp_path):
    """The whole slice on the CPU: 3 gloo ranks (``run_ranks``, each
    joined by ``join``), one halo shard each, against the JAX
    HaloSmoother over 3 devices."""
    want, _, want_pts = _jax_halo_run("60-120")
    params = SmoothingParams(centroidal_iters=ITERS, rel_tol=0.0,
                             **BANDS["60-120"])
    out = run_ranks(Job(_parity_mesh(PORT), params, ITERS, device="cpu",
                        dtype="float64"), 3, tmp_path)
    for r in out:
        _assert_same_run([StepResult(*t) for t in r["results"]], want)
        np.testing.assert_allclose(r["denormalized"], want_pts, rtol=0,
                                   atol=1e-9)


# -- against the port's single-device Smoother --------------------------------

def _single_and_halo(mesh, params, n_shards, geometry=None):
    runs = []
    for make in (lambda: Smoother(mesh, params, device="cpu",
                                  dtype=torch.float64),
                 lambda: HaloSmoother(mesh, params, n_shards=n_shards,
                                      device="cpu", dtype=torch.float64)):
        s = make()
        if geometry is not None:
            s.enable_boundary_smoothing(*geometry)
        runs.append((s, s.steps(params.centroidal_iters)))
    return runs


def test_halo_stress_8_shards_matches_single_device():
    params = SmoothingParams(centroidal_iters=4, rel_tol=0.0, min_angle=15.0)
    (s, rs), (h, rh) = _single_and_halo(_stress10(PORT), params, 8)
    assert max(r.n_frozen for r in rs) > 100     # the stress set is live
    assert h.topo.n_points > 1.3 * s.topo.n_points
    assert [r.n_frozen for r in rh] == [r.n_frozen for r in rs]
    for a, b in zip(rs, rh):
        assert b.residual == pytest.approx(a.residual, rel=1e-12)
    np.testing.assert_allclose(h.denormalize(), s.denormalize(), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("name", ["tc5", "tc7"])
def test_halo_boundary_matches_single_device(name):
    tc = ttc.ALL[name]()
    params = dataclasses.replace(tc.params, centroidal_iters=ITERS,
                                 rel_tol=0.0, max_step_length=BND_MAX_STEP)
    (s, rs), (h, rh) = _single_and_halo(tc.mesh, params, 3, tc.geometry)
    assert (h.layer is not None) == (name == "tc5") and h.bnd is not None
    assert [(r.n_frozen, r.n_ray_miss) for r in rh] == \
        [(r.n_frozen, r.n_ray_miss) for r in rs]
    for a, b in zip(rs, rh):
        assert b.residual == pytest.approx(a.residual, rel=1e-12)
    np.testing.assert_allclose(h.denormalize(), s.denormalize(), rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(h.boundary_setup.is_corner,
                                  s.to_external_point_field(
                                      s.boundary_setup.is_corner))
    top = tc.mesh.points[:, 2] > 1 - 1e-9
    assert (h.denormalize() - tc.mesh.points)[top, 2].max() > 0.05


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_halo_batched_matches_one_by_one(dtype, monkeypatch):
    """In batches of 4 through a face-angle stop (60/120 bites at the
    first iteration, which the host reruns with the fixed point) and one
    iteration a dispatch: bit-equal points, equal results."""
    monkeypatch.setenv("SMOOTHMESH_ITER_BATCH", "4")
    mesh, params = _parity_mesh(PORT), SmoothingParams(
        centroidal_iters=ITERS, rel_tol=0.0, **BANDS["60-120"])
    a = HaloSmoother(mesh, params, n_shards=3, device="cpu", dtype=dtype)
    b = HaloSmoother(mesh, params, n_shards=3, device="cpu", dtype=dtype)
    assert a.iter_batch == 4
    b.iter_batch = 1
    ra, rb = a.steps(ITERS), b.steps(ITERS)
    assert a.face_angle_stops >= 1
    assert [(r.iteration, r.residual, r.n_frozen) for r in ra] == \
        [(r.iteration, r.residual, r.n_frozen) for r in rb]
    assert torch.equal(a.points, b.points)
    # the face-angle free band never stops a batch
    params = dataclasses.replace(params, face_angle_constraint=False)
    a = HaloSmoother(mesh, params, n_shards=3, device="cpu", dtype=dtype)
    b = HaloSmoother(mesh, params, n_shards=3, device="cpu", dtype=dtype)
    b.iter_batch = 1
    ra, rb = a.steps(ITERS), b.steps(ITERS)
    assert a.face_angle_stops == 0
    assert [(r.residual, r.n_frozen) for r in ra] == \
        [(r.residual, r.n_frozen) for r in rb]
    assert torch.equal(a.points, b.points)


def test_halo_quality_matches_global_report():
    hs = _halo("default")
    hs.steps(2)
    un = hs.union
    topo = compile_topology(hs.mesh)
    assert int(un.claim_face.sum()) == topo.n_faces
    assert int(un.claim_edge.sum()) == topo.n_edges
    assert int(un.claim_cell.sum()) == topo.n_cells
    assert un.topo.n_internal_faces > topo.n_internal_faces
    q = hs.quality()
    q0 = quality_report(torch.from_numpy(hs.denormalize()),
                        to_device(topo, "cpu", QUALITY_TD_KEYS))
    assert set(q) == set(q0)
    for k, v in q0.items():
        if isinstance(v, int):
            assert q[k] == v, k
        else:
            assert q[k] == pytest.approx(v, rel=5e-4, abs=1e-5), k


def test_union_sync_exchanges():
    """consensus writes the owner's value + 0.0 to every holder (a -0.0
    arrives as +0.0, as the JAX psum), or_ ORs the holders."""
    rows = torch.tensor([0, 3, 1, 4])
    owner_rows = torch.tensor([3, 3, 1, 1])
    slots = torch.tensor([0, 0, 1, 1])
    s = UnionSync(rows, owner_rows, slots, 2)
    f = torch.tensor([5.0, 2.0, 9.0, -0.0, 7.0, 1.0])
    out = s.consensus(f)
    assert out.tolist() == [0.0, 2.0, 9.0, 0.0, 2.0, 1.0]
    assert not torch.signbit(out).any()
    m = torch.tensor([True, False, False, False, False, True])
    assert s.or_(m).tolist() == [True, False, False, True, False, True]
    assert s.all_max(torch.tensor(3.0)) == 3.0


def test_halo_runs_on_cuda_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HaloSmoother(_hex6(PORT), SmoothingParams(), n_shards=2)


# -- normalize=False and the global step scaling ------------------------------

def test_smoother_normalize_false_matches_jax():
    kw = dict(centroidal_iters=3, rel_tol=0.0, face_angle_constraint=False)
    sj = JaxSmoother(_parity_mesh(JAX), JaxParams(**kw), dtype=np.float64,
                     normalize=False, use_tile_engine=False)
    st = Smoother(_parity_mesh(PORT), SmoothingParams(**kw), device="cpu",
                  dtype=torch.float64, normalize=False)
    assert st._scale == 1.0 and not st._center.any()
    np.testing.assert_array_equal(st.denormalize(), _parity_mesh(PORT).points)
    _assert_same_run(st.steps(3), sj.steps(3))
    np.testing.assert_allclose(st.denormalize(), sj.denormalize(), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("kind", ["hex", "prism"])
def test_global_scaling_matches_jax(kind):
    make = {"hex": (hex_block(n=(6, 5, 4)), jax_hex(n=(6, 5, 4))),
            "prism": (prism_block(n=(5, 4, 3)), jax_prism(n=(5, 4, 3)))}
    pts = make[kind][0].points
    np.testing.assert_array_equal(pts, make[kind][1].points)
    rng = np.random.default_rng(3)
    prop = pts + rng.normal(scale=0.02, size=pts.shape)
    for max_step in (0.013, 10.0):     # scaled down; left at 1
        got = sm.constrain_max_step_length(
            torch.from_numpy(pts), torch.from_numpy(prop), max_step, 0.5,
            do_global_scaling=True)
        want = jsm.constrain_max_step_length(
            jnp.asarray(pts), jnp.asarray(prop), max_step, 0.5,
            do_global_scaling=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-15)
    assert float(sm.get_proposed_max_step_length(
        torch.from_numpy(pts), torch.from_numpy(prop))) == pytest.approx(
        float(jsm.get_proposed_max_step_length(jnp.asarray(pts),
                                               jnp.asarray(prop))),
        rel=1e-15)


def test_global_scaling_step_limit():
    """tests/test_kernels_vs_oracle.py's case: one common factor
    min(1, maxStep / (gmax * relFrac)) * relFrac, equal to the JAX
    function's, and through the halo union with its all_max hook."""
    m = perturb(hex_block(n=(4, 4, 4), grading=(3.0, 1.0, 0.3)), 0.02,
                seed=11)
    t = compile_topology(m)
    td = to_device(t, "cpu")
    pts = torch.from_numpy(m.points)
    from smoothmesh_torch import geometry as geo

    fg = geo.face_centres_areas(pts, td["face_points"], td["face_mask"],
                                td["face_npoints"])
    ctrs, _ = geo.cell_centres_vols(fg, td)
    cent = sm.centroidal_smoothing(pts, ctrs, td, False)
    gmax = float(sm.get_proposed_max_step_length(pts, cent))
    out = sm.constrain_max_step_length(pts, cent, 0.01, 0.5,
                                       do_global_scaling=True)
    step = out.numpy() - m.points
    prop = cent.numpy() - m.points
    nz = np.linalg.norm(prop, axis=1) > 1e-12
    ratio = np.linalg.norm(step[nz], axis=1) / np.linalg.norm(prop[nz],
                                                             axis=1)
    assert np.allclose(ratio, ratio[0], rtol=1e-9)
    assert np.isclose(ratio[0], min(1.0, 0.01 / (gmax * 0.5)) * 0.5,
                      rtol=1e-9)
    want = jsm.constrain_max_step_length(
        jnp.asarray(m.points), jnp.asarray(cent.numpy()), 0.01, 0.5,
        do_global_scaling=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0,
                               atol=1e-15)
    # on the union of 3 shards: the largest proposal over all shards
    un = halo.union_topology(halo.build_halo_shards(m, 3))
    rows = torch.from_numpy(un.l2g)
    calls = []

    class Recording(UnionSync):
        def all_max(self, x):
            calls.append(float(x))
            return x

    sync = Recording(*(torch.from_numpy(a) for a in (
        un.pair_rows, un.owner_rows(), un.pair_slots)), un.n_slots)
    got = sm.constrain_max_step_length(pts[rows], cent[rows], 0.01, 0.5,
                                       do_global_scaling=True, sync=sync)
    assert calls == [gmax]
    np.testing.assert_array_equal(got.numpy(), out.numpy()[un.l2g])


def test_halo_state_from_jax_blocks_with_layers_and_boundary():
    """tc5 (layers and boundary smoothing) carried across in the JAX
    HaloSmoother's block form ((D, Npad, ...) points, normals, layer and
    boundary blocks, as the JAX package's scatter builds them) runs on
    bit for bit with the port's own halo smoother of the same start."""
    tc = ttc.ALL["tc5"]()
    params = dataclasses.replace(tc.params, centroidal_iters=4,
                                 rel_tol=0.0, max_step_length=BND_MAX_STEP)
    hs = HaloSmoother(tc.mesh, params, n_shards=3, device="cpu",
                      dtype=torch.float64)
    setup = hs.enable_boundary_smoothing(*tc.geometry)
    sh, maps = hs.shards, hs.layer_maps
    g2ls = jscatter.g2l_maps(sh.l2g, tc.mesh.n_points)
    npad = sh.n_padded_points
    layer, normals = jscatter.scatter_layer_maps(maps, sh.l2g, g2ls, npad)
    bnd, rep, scalars = jscatter.scatter_boundary_setup(
        setup, maps, sh.l2g, g2ls, sh.topos, npad, hs.transform, hs._scale)
    carried = halo_state_from_jax(
        tc.mesh, 3, hs.shard_points(), dataclasses.asdict(hs.params),
        hs._center, hs._scale, device="cpu", dtype=torch.float64,
        normals=normals, smoothing_surface=bnd["smoothing_surface"],
        layer=layer, bnd=bnd, bnd_rep=rep,
        distance_tolerance=scalars["distance_tolerance"])
    assert carried.layer is not None and carried.bnd is not None
    want, got = hs.steps(4), carried.steps(4)
    assert [(r.residual, r.n_frozen, r.n_ray_miss) for r in got] == \
        [(r.residual, r.n_frozen, r.n_ray_miss) for r in want]
    assert torch.equal(carried.points, hs.points)
    assert torch.equal(carried.normals, hs.normals)
