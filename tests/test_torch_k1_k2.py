"""What the card's K1 (face geometry) and K2 (cell centres and volumes)
rely on, checked on the CPU:

- K2's cell-face words (``device.pack_cell_faces``) decode to exactly
  ``cell_faces``, its mask and the owner sign, on the 14x12x10 hex, the
  8x8x6 prism, a 12^3 graded bench block and tc1-tc8;
- a face id of 2^30 or more is refused;
- the kernels' forms, written here in plain torch as the kernels
  compute (one pass with the row in registers, each slot skipped where
  it is not valid, the sign from the word), equal
  ``face_centres_areas_plain`` and ``cell_centres_vols_plain`` bit for
  bit in float32 and float64, on the mesh's points and on points moved
  by a random step.
"""

import functools

import numpy as np
import pytest
import torch

from smoothmesh_torch import geometry as geo
from smoothmesh_torch import testcases as tcs
from smoothmesh_torch.device import (MAX_CELL_FACE, PACKED_KEYS,
                                     pack_cell_faces, to_device)
from smoothmesh_torch.geometry import dot3, norm3
from smoothmesh_torch.mesh.blockmesh import hex_block, perturb, prism_block
from smoothmesh_torch.mesh.tiling import permute_mesh
from smoothmesh_torch.mesh.topology import compile_topology
from smoothmesh_torch.quality import mesh_stats

torch.set_num_threads(1)

BLOCKS = ("hex", "prism", "graded")
KINDS = [*BLOCKS, *tcs.ALL]
DTYPES = (torch.float32, torch.float64)
#: the moved points' random step, in minimum edge lengths
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
    """(topology, its device tables and the cell-face words on the CPU,
    points, points moved by a random step) of one mesh, in float64."""
    mesh, _ = permute_mesh(_mesh(kind))
    topo = compile_topology(mesh)
    keys = ("face_points", "face_mask", "face_npoints", "owner",
            "cell_faces", "cell_faces_mask", "cell_face_words")
    td = to_device(topo, "cpu", keys)
    pts = torch.from_numpy(np.asarray(mesh.points, np.float64))
    h = mesh_stats(mesh.points, topo.edges).min_edge_length
    rng = np.random.default_rng(13)
    moved = pts + torch.from_numpy(rng.uniform(-STEP, STEP, pts.shape) * h)
    return topo, td, pts, moved


def _bits(t):
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def _bits_equal(a, b):
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("kind", KINDS)
def test_cell_face_words_decode_to_the_tables(kind):
    topo, td, *_ = _setup(kind)
    assert "cell_face_words" in PACKED_KEYS
    w = td["cell_face_words"]
    assert w.dtype == torch.int32 and w.shape == td["cell_faces"].shape
    w = w.long()
    mask = w >= 0
    assert torch.equal(mask, td["cell_faces_mask"])
    assert bool((w[~mask] == -1).all())
    f = w & MAX_CELL_FACE
    assert torch.equal(f[mask], td["cell_faces"].long()[mask])
    cells = torch.arange(w.shape[0])[:, None].expand_as(w)
    neighbour = td["owner"].long()[td["cell_faces"].long()] != cells
    assert torch.equal(((w >> 30) & 1).bool()[mask], neighbour[mask])
    # both signs occur: every internal face is named by its two cells
    assert int(neighbour[mask].sum()) == int(topo.has_neighbour.sum())


def test_pack_cell_faces_refuses_face_ids_beyond_30_bits():
    owner = np.array([0, 0, 1], dtype=np.int32)
    ok = np.array([[0, 1, 2], [2, 0, 0]], dtype=np.int32)
    mask = np.array([[True, True, True], [True, False, False]])
    words = pack_cell_faces(owner, ok, mask)
    assert words.tolist() == [[0, 1, 2 | (1 << 30)], [2, -1, -1]]
    big = ok.copy()
    big[0, 1] = MAX_CELL_FACE + 1            # 2^30
    with pytest.raises(ValueError, match="2\\^30"):
        pack_cell_faces(owner, big, mask)
    big[0, 1] = MAX_CELL_FACE                # 2^30 - 1 fits (no owner row)
    with pytest.raises(IndexError):
        pack_cell_faces(owner, big, mask)
    # a padded slot's table entry is not a face id
    pad = ok.copy()
    pad[1, 2] = MAX_CELL_FACE + 1
    assert pack_cell_faces(owner, pad, mask).tolist() == words.tolist()


# -- K1 ---------------------------------------------------------------------

def _k1_register_form(points, face_points, face_npoints):
    """K1 as the kernel computes it (csrc/face_geometry.cu), in plain
    torch: the row's n points gathered once, slots at or past n skipped,
    the next vertex wrapping at n - 1 -> FaceGeometry."""
    p = points[face_points.long()]                     # (F, W, 3)
    n = face_npoints.long()[:, None]
    W = face_points.shape[1]
    zero = torch.zeros_like(p[:, 0])
    s = zero
    for w in range(W):
        s = torch.where(w < n, s + p[:, w], s)
    vm = s / n.to(p.dtype)
    sum_n, sum_ac = zero, zero
    sum_a = torch.zeros_like(p[:, 0, :1])
    for w in range(W):
        nxt = torch.where(w + 1 < n, p[:, (w + 1) % W], p[:, 0])
        c = p[:, w] + nxt + vm
        a, b = nxt - p[:, w], vm - p[:, w]
        ax, ay, az = a.unbind(-1)
        bx, by, bz = b.unbind(-1)
        nv = torch.stack([ay * bz - az * by, az * bx - ax * bz,
                          ax * by - ay * bx], -1)
        area = norm3(nv, keepdim=True)
        live = w < n
        sum_n = torch.where(live, sum_n + nv, sum_n)
        sum_a = torch.where(live, sum_a + area, sum_a)
        sum_ac = torch.where(live, sum_ac + area * c, sum_ac)
    good = sum_a > geo.ROOT_VSMALL
    fc = torch.where(good, sum_ac / (3.0 * sum_a.clamp_min(geo.VSMALL)), vm)
    fa = torch.where(good, 0.5 * sum_n, zero)
    return geo.FaceGeometry(fc, fa, vm)


@pytest.mark.parametrize("kind", KINDS)
def test_k1_register_form_is_bit_equal_to_the_plain_version(kind):
    _, td, pts64, moved64 = _setup(kind)
    fp, fm, fn = td["face_points"], td["face_mask"], td["face_npoints"]
    assert torch.equal(fm, torch.arange(fp.shape[1]) < fn[:, None].long())
    for dtype in DTYPES:
        for pts in (pts64.to(dtype), moved64.to(dtype)):
            want = geo.face_centres_areas_plain(pts, fp, fm, fn)
            got = _k1_register_form(pts, fp, fn)
            for g, w_ in zip(got, want):
                assert torch.isfinite(w_).all()
                assert _bits_equal(g, w_), (kind, dtype)


def test_k1_degenerate_faces_take_the_vertex_mean():
    _, td, pts64, _ = _setup("hex")
    fp, fm, fn = td["face_points"], td["face_mask"], td["face_npoints"]
    pts = pts64.to(torch.float32).clone()
    # collapse the first 200 points (spatially clustered) onto one: the
    # faces among them have zero area
    pts[:200] = pts[0]
    want = geo.face_centres_areas_plain(pts, fp, fm, fn)
    got = _k1_register_form(pts, fp, fn)
    flat = (fp.long() < 200).all(1)
    assert int(flat.sum()) > 10
    assert bool((want.areas[flat] == 0).all())
    assert torch.equal(want.centres[flat], want.means[flat])
    for g, w_ in zip(got, want):
        assert _bits_equal(g, w_)


# -- K2 ---------------------------------------------------------------------

def _k2_register_form(face_geo, words):
    """K2 as the kernel computes it (csrc/cell_centres.cu), in plain
    torch: the row's faces gathered once through the words, invalid
    slots skipped, the sign from bit 30 -> (centres, volumes)."""
    w = words.long()
    ok = w >= 0
    f = torch.where(ok, w & MAX_CELL_FACE, 0)
    fc, fa = face_geo.centres[f], face_geo.areas[f]     # (C, W, 3)
    live = ok[..., None]
    s = torch.zeros_like(fc[:, 0])
    for k in range(w.shape[1]):
        s = torch.where(live[:, k], s + fc[:, k], s)
    nf = ok.sum(1, keepdim=True).to(fc.dtype)
    ce = s / nf.clamp_min(1.0)
    vol3 = torch.zeros_like(fc[:, 0, 0])
    num = torch.zeros_like(s)
    for k in range(w.shape[1]):
        sign = torch.where(((w[:, k] >> 30) & 1).bool(), -1.0, 1.0).to(
            fc.dtype)
        pyr3 = sign * dot3(fa[:, k], fc[:, k] - ce)
        pc = 0.75 * fc[:, k] + 0.25 * ce
        vol3 = torch.where(ok[:, k], vol3 + pyr3, vol3)
        num = torch.where(live[:, k], num + pyr3[:, None] * pc, num)
    good = vol3.abs() > geo.VSMALL
    cc = torch.where(good[:, None],
                     num / torch.where(good, vol3, 1.0)[:, None], ce)
    return cc, vol3 / 3.0


@pytest.mark.parametrize("kind", KINDS)
def test_k2_register_form_is_bit_equal_to_the_plain_version(kind):
    _, td, pts64, moved64 = _setup(kind)
    for dtype in DTYPES:
        for pts in (pts64.to(dtype), moved64.to(dtype)):
            fg = geo.face_centres_areas_plain(pts, td["face_points"],
                                              td["face_mask"],
                                              td["face_npoints"])
            want = geo.cell_centres_vols_plain(fg, td)
            got = _k2_register_form(fg, td["cell_face_words"])
            for g, w_ in zip(got, want):
                assert torch.isfinite(w_).all()
                assert _bits_equal(g, w_), (kind, dtype)
    # the wrapper on CPU tensors is the plain version
    cc, vol = geo.cell_centres_vols(fg, td)
    assert _bits_equal(cc, want[0]) and _bits_equal(vol, want[1])


def test_k2_flat_cells_take_the_centre_estimate():
    _, td, pts64, _ = _setup("hex")
    fg = geo.face_centres_areas_plain(pts64.to(torch.float32),
                                      td["face_points"], td["face_mask"],
                                      td["face_npoints"])
    # zero the area vectors of the first cell's faces: |vol3| <= VSMALL
    areas = fg.areas.clone()
    areas[td["cell_faces"][0].long()] = 0.0
    fg = geo.FaceGeometry(fg.centres, areas, fg.means)
    want = geo.cell_centres_vols_plain(fg, td)
    got = _k2_register_form(fg, td["cell_face_words"])
    assert float(want[1][0]) == 0.0
    for g, w_ in zip(got, want):
        assert _bits_equal(g, w_)
