"""What the card's K4 (the freezes) and K5 (the edge face angles) rely
on, checked on the CPU:

- the packed int16 words decode to exactly the old tables: K4's wedge
  words (``device.pack_wedges``) to ``wedge_prev``/``wedge_next`` as
  slots of the ``point_points`` row and the ``point_faces`` mask, K5's
  cell words (``device.pack_edge_cells``) to ``edge_cell_f0``/``f1``
  and the ``edge_cells`` mask, on the 14x12x10 hex, the 8x8x6 prism, a
  12^3 graded bench block and tc1-tc8;
- ``to_device`` refuses a mesh too wide for the words;
- the kernels' slot forms, written here in plain torch as the kernels
  compute (K4: each neighbour's vectors and clamped norms once per
  point, the wedges read through the words, no norm in the wedge loop;
  K5: each face of an edge projected once, at the slots its valid
  cells name), equal ``freeze_constraints_plain`` and
  ``edge_face_angles_plain`` bit for bit in float32 and float64, at
  the main path's thresholds and at tight ones that freeze many points.
"""

import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

from smoothmesh_torch import geometry as geo
from smoothmesh_torch import testcases as tcs
from smoothmesh_torch.device import PACKED_KEYS, to_device
from smoothmesh_torch.geometry import dot3, norm3
from smoothmesh_torch.mesh.blockmesh import hex_block, perturb, prism_block
from smoothmesh_torch.mesh.tiling import permute_mesh
from smoothmesh_torch.mesh.topology import compile_topology
from smoothmesh_torch.ops import constraints as con
from smoothmesh_torch.params import SmoothingParams
from smoothmesh_torch.quality import mesh_stats

torch.set_num_threads(1)

BLOCKS = ("hex", "prism", "graded")
KINDS = [*BLOCKS, *tcs.ALL]
DTYPES = (torch.float32, torch.float64)
#: the proposal's random step, in minimum edge lengths: large enough
#: that both freezes bite at the tight thresholds
STEP = 0.4


def _mesh(kind):
    if kind == "hex":
        return perturb(hex_block(n=(14, 12, 10)), amplitude=0.05, seed=5)
    if kind == "prism":
        return perturb(prism_block(n=(8, 8, 6)), amplitude=0.04, seed=6)
    if kind == "graded":
        base = hex_block(n=(12, 12, 12), grading=(2.0, 1.0, 0.5))
        spacing = min(np.diff(np.unique(base.points[:, a])).min()
                      for a in range(3))
        return perturb(base, amplitude=0.25 * spacing, seed=3)
    return tcs.ALL[kind]().mesh


@functools.lru_cache(maxsize=None)
def _setup(kind):
    """(topology, its full device tables and packed words on the CPU,
    points, a random proposal) of one mesh, in float64."""
    mesh, _ = permute_mesh(_mesh(kind))
    topo = compile_topology(mesh)
    td = to_device(topo, "cpu")
    td.update(to_device(topo, "cpu", PACKED_KEYS))
    pts = torch.from_numpy(np.asarray(mesh.points, np.float64))
    h = mesh_stats(mesh.points, topo.edges).min_edge_length
    rng = np.random.default_rng(11)
    prop = pts + torch.from_numpy(rng.uniform(-STEP, STEP, pts.shape) * h)
    return topo, td, pts, prop, h


@pytest.mark.parametrize("kind", KINDS)
def test_words_decode_to_the_old_tables(kind):
    topo, td, *_ = _setup(kind)
    assert td["wedge_words"].dtype == torch.int16
    assert td["edge_cell_words"].dtype == torch.int16
    w = td["wedge_words"].long()
    mask = w < 0
    assert torch.equal(mask, td["point_faces_mask"])
    pp = td["point_points"].long()
    for shift, table in ((0, "wedge_prev"), (5, "wedge_next")):
        slot = (w >> shift) & 31
        assert bool(td["point_points_mask"].gather(1, slot)[mask].all())
        assert torch.equal(pp.gather(1, slot)[mask],
                           td[table].long()[mask]), table
    assert bool((w[~mask] == 0).all())
    c = td["edge_cell_words"].long()
    assert torch.equal(c < 0, td["edge_cells_mask"])
    assert torch.equal(c & 127, td["edge_cell_f0"].long())
    assert torch.equal((c >> 7) & 127, td["edge_cell_f1"].long())
    assert int(mask.sum()) and int((c < 0).sum())


def test_to_device_refuses_too_wide_a_mesh():
    topo = _setup("tc8")[0]
    n, wp = topo.point_points.shape
    pad = ((0, 0), (0, 33 - wp))
    wide = dataclasses.replace(
        topo, point_points=np.pad(topo.point_points, pad),
        point_points_mask=np.pad(topo.point_points_mask, pad))
    assert wide.point_points.shape == (n, 33)
    with pytest.raises(ValueError, match="width 33 > 32"):
        to_device(wide, "cpu", {"wedge_words"})
    to_device(wide, "cpu", {"point_points"})      # the plain tables stage
    e = topo.edge_faces.shape
    wide = dataclasses.replace(
        topo, edge_faces=np.pad(topo.edge_faces, ((0, 0), (0, 128 - e[1]))))
    with pytest.raises(ValueError, match="width 128 >= 128"):
        to_device(wide, "cpu", {"edge_cell_words"})
    # a wedge whose neighbour is not in its point's row
    bad = dataclasses.replace(topo, wedge_prev=np.where(
        topo.point_faces_mask, (topo.wedge_prev + 1) % n, 0))
    with pytest.raises(ValueError, match="not in its point's"):
        to_device(bad, "cpu", {"wedge_words"})


# -- K4 ---------------------------------------------------------------------

def _k4_slot_form(points, proposed, td, min_edge, total_min_freeze,
                  min_angle_rad, frozen):
    """K4 as the kernel computes it (csrc/freeze.cu), in plain torch:
    -> (freeze mask, max current cosine, max proposed cosine)."""
    pp = td["point_points"].long()
    ppm = td["point_points_mask"]
    p_j, n_j = points[pp], proposed[pp]
    vc = p_j - points[:, None]          # own_c -> P_j
    vp = p_j - proposed[:, None]        # own_p -> P_j
    vn = n_j - proposed[:, None]        # own_p -> N_j
    nc, np_ = norm3(vc), norm3(vp)
    cur_min = torch.where(ppm, nc, torch.inf).amin(1)
    new_min = torch.where(ppm, np_, torch.inf).amin(1)
    if total_min_freeze:
        fr = torch.minimum(cur_min, new_min) < min_edge
    else:
        fr = (new_min < min_edge) & (new_min < cur_min)
    # the records: vectors and clamped norms, once per neighbour
    recs = [(v, n.clamp_min(con.VSMALL))
            for v, n in ((vc, nc), (vp, np_), (vn, norm3(vn)))]
    w = td["wedge_words"].long()
    ok = w < 0
    a, b = w & 31, (w >> 5) & 31

    def at(rec, slot):
        v, n = rec
        return (v.gather(1, slot[..., None].expand(-1, -1, 3)),
                n.gather(1, slot))

    def cosine(ra, rb):
        return (dot3(ra[0], rb[0]) / (ra[1] * rb[1])).clamp(
            -con.ACOS_CLAMP, con.ACOS_CLAMP)

    ca, pa, na = (at(r, a) for r in recs)
    cb, pb, nb = (at(r, b) for r in recs)
    cos_c = cosine(ca, cb)
    cos_n = torch.maximum(torch.maximum(cosine(pa, pb), cosine(na, nb)),
                          torch.maximum(cosine(pa, nb), cosine(na, pb)))
    max_c = torch.where(ok, cos_c, -2.0).amax(1)
    max_n = torch.where(ok, cos_n, -2.0).amax(1)
    fr = fr | ((max_n > math.cos(min_angle_rad)) & (max_n > max_c))
    return frozen | fr, max_c, max_n


def _k4_plain_cosines(points, proposed, td):
    """freeze_constraints_plain's max cosines (its own helpers)."""
    mask = td["point_faces_mask"]
    cp0, cp1, cp2, np0, np1, np2 = con._wedge_coords(points, proposed, td)
    cos_c = con._cos_angle(cp0, cp1, cp2)
    cos_n = torch.maximum(
        torch.maximum(con._cos_angle(np0, cp1, cp2),
                      con._cos_angle(np0, np1, np2)),
        torch.maximum(con._cos_angle(np0, cp1, np2),
                      con._cos_angle(np0, np1, cp2)))
    return (torch.where(mask, cos_c, -2.0).amax(1),
            torch.where(mask, cos_n, -2.0).amax(1))


def _bits_equal(a, b):
    return torch.equal(a, b) or torch.equal(
        a.view(torch.int64 if a.dtype == torch.float64 else torch.int32),
        b.view(torch.int64 if b.dtype == torch.float64 else torch.int32))


@pytest.mark.parametrize("kind", KINDS)
def test_k4_slot_form_is_bit_equal_to_the_plain_version(kind):
    topo, td, pts64, prop64, h = _setup(kind)
    p = SmoothingParams().resolve(h)
    assert p.edge_angle_constraint
    thresholds = {"main": (p.min_edge_length, p.min_angle_rad),
                  "tight": (3.0 * h, math.radians(60.0))}
    frozen_in = torch.from_numpy(np.random.default_rng(2).random(
        topo.n_points) < 0.05)
    for dtype in DTYPES:
        pts, prop = pts64.to(dtype), prop64.to(dtype)
        want_c, want_n = _k4_plain_cosines(pts, prop, td)
        for name, (edge, angle) in thresholds.items():
            for tmf in (False, True):
                for frozen in (torch.zeros_like(frozen_in), frozen_in):
                    want = con.freeze_constraints_plain(
                        pts, prop, td, edge, tmf, angle, True, frozen)
                    got, max_c, max_n = _k4_slot_form(
                        pts, prop, td, edge, tmf, angle, frozen)
                    assert torch.equal(got, want), (dtype, name, tmf)
            if name == "tight":
                # not vacuous: the angle freeze bites on its own
                angle_only = con.freeze_constraints_plain(
                    pts, prop, td, 0.0, False, angle, True,
                    torch.zeros_like(frozen_in))
                assert int(angle_only.sum()) > 0.05 * topo.n_points, kind
        assert _bits_equal(max_c, want_c) and _bits_equal(max_n, want_n)


# -- K5 ---------------------------------------------------------------------

def _k5_slot_form(points, means, cell_ctrs, td):
    """K5 as the kernel computes it (csrc/face_angles.cu), in plain
    torch: each face slot that a valid cell names projected once, each
    cell centre once -> (E, 2) [u_min | u_max]."""
    edges = td["edges"].long()
    e0, e1 = points[edges[:, 0]], points[edges[:, 1]]
    ctr = 0.5 * (e0 + e1)
    ev = e1 - e0
    ev = ev / norm3(ev, keepdim=True).clamp_min(con.VSMALL)
    ctr, ev = ctr[:, None], ev[:, None]

    def proj(x):
        dt = dot3(ctr - x, ev)
        d = x + dt[..., None] * ev - ctr
        return d / norm3(d, keepdim=True).clamp_min(con.VSMALL)

    w = td["edge_cell_words"].long()
    ok = w < 0
    s0, s1 = w & 127, (w >> 7) & 127
    ef = td["edge_faces"].long()
    rows = torch.arange(ef.shape[0])[:, None].expand_as(s0)[ok]
    named = torch.zeros(ef.shape, dtype=torch.bool)
    named[rows, s0[ok]] = True
    named[rows, s1[ok]] = True
    pv = torch.where(named[..., None], proj(means[ef]), torch.nan)
    cv = proj(cell_ctrs[td["edge_cells"].long()])
    p0 = pv.gather(1, s0[..., None].expand(-1, -1, 3))
    p1 = pv.gather(1, s1[..., None].expand(-1, -1, 3))
    a = dot3(p0, cv).clamp(-con.ACOS_CLAMP, con.ACOS_CLAMP)
    b = dot3(cv, p1).clamp(-con.ACOS_CLAMP, con.ACOS_CLAMP)
    sa, sb = torch.sqrt(1.0 - a * a), torch.sqrt(1.0 - b * b)
    cos_s = a * b - sa * sb
    sin_s = sa * b + a * sb
    u = torch.where(sin_s >= 0, 1.0 - cos_s, 3.0 + cos_s)
    return torch.stack([torch.where(ok, u, 4.0).amin(1),
                        torch.where(ok, u, 0.0).amax(1)], 1)


@pytest.mark.parametrize("kind", KINDS)
def test_k5_slot_form_is_bit_equal_to_the_plain_version(kind):
    topo, td, pts64, prop64, _ = _setup(kind)
    for dtype in DTYPES:
        for pts in (pts64.to(dtype), prop64.to(dtype)):
            means = con.simple_face_centres(pts, td)
            cc = geo.cell_centres(pts, td)
            want = con.edge_face_angles_plain(pts, means, cc, td)
            got = _k5_slot_form(pts, means, cc, td)
            assert torch.isfinite(got).all()
            assert _bits_equal(got, want), (kind, dtype)
    # every valid cell's faces are projected; no named face is invalid
    w = td["edge_cell_words"].long()
    ok = w < 0
    for shift in (0, 7):
        s = (w >> shift) & 127
        assert bool(td["edge_faces_mask"].gather(1, s)[ok].all())
