"""Quality-constraint freezes (the reference's L5 layer):

  - ``restrict_edge_shortening``          (reference src/smoothMesh.C:602-652)
  - ``restrict_min_edge_angle_decrease``  (reference src/smoothMesh.C:766-930)
  - ``restrict_face_angle_deterioration`` (reference src/smoothMesh.C:938-1437)

Each returns an updated boolean freeze mask; frozen points revert to
their current coordinates at the end of the iteration (reference
src/smoothMesh.C:2384-2392).  The first two are the reference's
clamped-acos formulation; :func:`freeze_constraints` is the fused stage
the driver calls, which compares clamped cosines instead (acos is
strictly decreasing, so every angle comparison maps to the reversed
cosine comparison): the hand-written kernel ``csrc/freeze.cu`` (K4) for
float32 CUDA tensors, the plain version for CPU tensors and float64
CUDA tensors (``kernels.takes_kernel``).

The face-angle constraint mirrors ``smoothmesh_tpu.ops.constraints``:
the plain per-edge pass (``face_angles_for_edges``,
``current_face_angles_per_point``), the current per-point angles in the
tile engine's u encoding (:func:`face_angles_per_point`: kernels
``csrc/face_angles.cu`` = K5 and ``csrc/point_face_angles.cu`` = K6 on
float32 CUDA tensors, their plain versions on CPU tensors and float64
CUDA tensors), and the fixed point
:func:`restrict_face_angle_deterioration`, which is plain PyTorch as
its JAX counterpart is plain XLA.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from smoothmesh_torch import kernels
from smoothmesh_torch.geometry import dot3, norm3

VSMALL = 1e-30
ACOS_CLAMP = 0.99999
TWO_PI = 2.0 * math.pi
#: Evaluations per chunk of the face-angle passes: edges of the per-edge
#: pass, (point, edge, substitution) triples of the fixed point.  Bounds
#: their memory (a few hundred MB in float32) at any mesh size.
EVAL_CHUNK = 1 << 18


def _min_edge_lengths(points, proposed, td):
    """Per point: min current edge length, and min length from the
    proposed position to the neighbours' current positions."""
    pp = td["point_points"].long()
    mask = td["point_points_mask"]
    neigh = points[pp]                                   # (N, W, 3)
    cur_len = norm3(neigh - points[:, None, :])
    new_len = norm3(neigh - proposed[:, None, :])
    cur_min = torch.where(mask, cur_len, torch.inf).amin(1)
    new_min = torch.where(mask, new_len, torch.inf).amin(1)
    return cur_min, new_min


def _edge_freeze(cur_min, new_min, min_edge_length, total_min_freeze):
    if total_min_freeze:
        return torch.minimum(cur_min, new_min) < min_edge_length
    return (new_min < min_edge_length) & (new_min < cur_min)


def restrict_edge_shortening(points, proposed, td, min_edge_length,
                             total_min_freeze, frozen):
    """Freeze points whose shortest edge would shrink below threshold."""
    cur_min, new_min = _min_edge_lengths(points, proposed, td)
    return frozen | _edge_freeze(cur_min, new_min, min_edge_length,
                                 total_min_freeze)


def _edge_edge_angle(c, p1, p2):
    """Angle at c between rays to p1 and p2 (reference edgeEdgeAngle,
    src/smoothMesh.C:766-786): normalized dot, clamped acos."""
    v1 = p1 - c
    v2 = p2 - c
    v1 = v1 / norm3(v1, keepdim=True).clamp_min(VSMALL)
    v2 = v2 / norm3(v2, keepdim=True).clamp_min(VSMALL)
    cos_a = dot3(v1, v2)
    return torch.arccos(cos_a.clamp(-ACOS_CLAMP, ACOS_CLAMP))


def _wedge_coords(points, proposed, td):
    prev = td["wedge_prev"].long()
    nxt = td["wedge_next"].long()
    return (points[:, None, :], points[prev], points[nxt],
            proposed[:, None, :], proposed[prev], proposed[nxt])


def restrict_min_edge_angle_decrease(points, proposed, td, min_angle_rad,
                                     frozen):
    """Freeze points whose minimum edge-edge wedge angle would decrease
    below ``min_angle`` (reference calc_min_edge_angles +
    restrictMinEdgeAngleDecrease, src/smoothMesh.C:837-930).

    Per (point, face) wedge the minimum over five evaluations: current,
    and the four moved/unmoved endpoint combinations.
    """
    mask = td["point_faces_mask"]                     # (N, W)
    cp0, cp1, cp2, np0, np1, np2 = _wedge_coords(points, proposed, td)

    c_angle = _edge_edge_angle(cp0, cp1, cp2)
    n_angle = torch.minimum(
        torch.minimum(_edge_edge_angle(np0, cp1, cp2),
                      _edge_edge_angle(np0, np1, np2)),
        torch.minimum(_edge_edge_angle(np0, cp1, np2),
                      _edge_edge_angle(np0, np1, cp2)),
    )
    min_c = torch.where(mask, c_angle, torch.inf).amin(1)
    min_n = torch.where(mask, n_angle, torch.inf).amin(1)

    fr = (min_n < min_angle_rad) & (min_n < min_c)
    return frozen | fr


def _cos_angle(c, p1, p2):
    """Clamped cosine of the angle at c between rays to p1 and p2."""
    v1 = p1 - c
    v2 = p2 - c
    d = dot3(v1, v2) / (norm3(v1).clamp_min(VSMALL)
                        * norm3(v2).clamp_min(VSMALL))
    return d.clamp(-ACOS_CLAMP, ACOS_CLAMP)


def freeze_constraints_plain(points, proposed, td, min_edge_length,
                             total_min_freeze, min_angle_rad,
                             edge_angle_constraint, frozen):
    """Edge-shortening + edge-angle freezes ORed into ``frozen``, with
    the angles compared as clamped cosines (what K4 computes)."""
    cur_min, new_min = _min_edge_lengths(points, proposed, td)
    fr = _edge_freeze(cur_min, new_min, min_edge_length, total_min_freeze)
    if edge_angle_constraint:
        mask = td["point_faces_mask"]
        cp0, cp1, cp2, np0, np1, np2 = _wedge_coords(points, proposed, td)
        cos_c = _cos_angle(cp0, cp1, cp2)
        cos_n = torch.maximum(
            torch.maximum(_cos_angle(np0, cp1, cp2),
                          _cos_angle(np0, np1, np2)),
            torch.maximum(_cos_angle(np0, cp1, np2),
                          _cos_angle(np0, np1, cp2)))
        max_c = torch.where(mask, cos_c, -2.0).amax(1)
        max_n = torch.where(mask, cos_n, -2.0).amax(1)
        fr = fr | ((max_n > math.cos(min_angle_rad)) & (max_n > max_c))
    return frozen | fr


def freeze_constraints(points, proposed, td, min_edge_length,
                       total_min_freeze, min_angle_rad,
                       edge_angle_constraint, frozen):
    """The fused freeze stage (K4): -> (N,) bool freeze mask.  On the
    card the kernel reads the wedges as ``td["wedge_words"]``
    (:func:`smoothmesh_torch.device.pack_wedges`), not ``wedge_prev``,
    ``wedge_next`` and ``point_faces_mask``."""
    dev = points.device
    if not kernels.takes_kernel(dev, points.dtype, "freeze_constraints"):
        return freeze_constraints_plain(
            points, proposed, td, min_edge_length, total_min_freeze,
            min_angle_rad, edge_angle_constraint, frozen)
    n = points.shape[0]
    pp, ppm = td["point_points"], td["point_points_mask"]
    words = td["wedge_words"]
    wp, wf = pp.shape[1], words.shape[1]
    kernels.check(points, "points", torch.float32, (n, 3), dev)
    kernels.check(proposed, "proposed", torch.float32, (n, 3), dev)
    kernels.check(pp, "point_points", torch.int32, (n, wp), dev)
    kernels.check(ppm, "point_points_mask", torch.bool, (n, wp), dev)
    kernels.check(words, "wedge_words", torch.int16, (n, wf), dev)
    kernels.check(frozen, "frozen", torch.bool, (n,), dev)
    if words.data_ptr() % 8:
        raise ValueError("wedge_words: not 8-byte aligned")
    out = torch.empty((n,), dtype=torch.bool, device=dev)
    kernels.FREEZE.launch(
        points.data_ptr(), proposed.data_ptr(), pp.data_ptr(),
        ppm.data_ptr(), words.data_ptr(), frozen.data_ptr(), n, wp, wf,
        float(min_edge_length), int(bool(total_min_freeze)),
        math.cos(min_angle_rad), int(bool(edge_angle_constraint)),
        out.data_ptr(), device=out.device)
    return out


# ---------------------------------------------------------------------------
# Face-angle constraint
# ---------------------------------------------------------------------------

def _acos_c(x):
    return torch.arccos(x.clamp(-ACOS_CLAMP, ACOS_CLAMP))


def _pair_metric(a, b, u_space):
    """The reference's acos(a) + acos(b) face-angle sum, or its
    monotone u-space twin (the encoding of K5, see
    ``csrc/face_angles.cu``): u = 1 - cos(A+B) when sin(A+B) >= 0, else
    3 + cos(A+B).  Both are strictly increasing in the angle, so
    min/max/threshold comparisons agree; u space is used when the
    current per-point angles come from K5/K6, so that current and
    substituted values share one representation."""
    if not u_space:
        return _acos_c(a) + _acos_c(b)
    a = a.clamp(-ACOS_CLAMP, ACOS_CLAMP)
    b = b.clamp(-ACOS_CLAMP, ACOS_CLAMP)
    sa = torch.sqrt(1.0 - a * a)
    sb = torch.sqrt(1.0 - b * b)
    cos_s = a * b - sa * sb
    sin_s = sa * b + a * sb
    return torch.where(sin_s >= 0, 1.0 - cos_s, 3.0 + cos_s)


def angle_to_u(theta: float) -> float:
    """u-space image of an angle threshold in [0, pi]."""
    return 1.0 - math.cos(theta)


def simple_face_centres(points, td):
    """Per-face vertex means (reference calcFaceCenter
    src/smoothMesh.C:1103-1130 without substitutions); K1 emits the same
    as ``FaceGeometry.means``."""
    m = td["face_mask"][..., None].to(points.dtype)
    n = td["face_npoints"].to(points.dtype)[:, None]
    return (points[td["face_points"].long()] * m).sum(1) / n.clamp_min(1.0)


def _proj_unit(x, ctr, ev):
    """x projected onto the plane through ``ctr`` normal to the unit
    vector ``ev``, as the unit vector from ``ctr`` (reference
    src/smoothMesh.C:1189-1195)."""
    dt = dot3(ctr - x, ev)
    d = x + dt[..., None] * ev - ctr
    return d / norm3(d, keepdim=True).clamp_min(VSMALL)


def _edge_minmax(e0, e1, fc, cc, f0, f1, cmask, u_space):
    """Min/max over an edge's valid cells of the face-face angle sum
    (reference calcMinMaxFaceAngleForEdge src/smoothMesh.C:1135-1231).

    e0, e1: (..., 3) edge ends; fc: (..., WF, 3) face centres of the
    edge's faces; cc: (..., WC, 3) its cells' centres; f0, f1, cmask:
    (..., WC) each cell's two face slots and validity, broadcastable
    to cc's leading shape.  Every caller evaluates through here, so an
    unchanged configuration gives bit-identical values on every path.
    """
    ctr = 0.5 * (e0 + e1)
    ev = e1 - e0
    ev = ev / norm3(ev, keepdim=True).clamp_min(VSMALL)
    ctr, ev = ctr[..., None, :], ev[..., None, :]
    pv = _proj_unit(fc, ctr, ev)                        # (..., WF, 3)
    cv = _proj_unit(cc, ctr, ev)                        # (..., WC, 3)
    p0 = torch.gather(pv, -2, f0.long()[..., None].expand(cv.shape))
    p1 = torch.gather(pv, -2, f1.long()[..., None].expand(cv.shape))
    ang = _pair_metric(dot3(p0, cv), dot3(cv, p1), u_space)
    big = 4.0 if u_space else TWO_PI
    return (torch.where(cmask, ang, big).amin(-1),
            torch.where(cmask, ang, 0.0).amax(-1))


def face_angles_for_edges(points, cell_ctrs, td, fc_base=None,
                          u_space=False, rows=slice(None)):
    """Min/max projected face-face angle of the edges ``rows`` with the
    current points (the JAX ``face_angles_for_edges`` without
    substitutions): face vertex means and current cell centres
    projected onto each edge's normal plane; per adjacent cell the sum
    of the two face->cell-centre angles; min/max over cells."""
    if fc_base is None:
        fc_base = simple_face_centres(points, td)
    edges = td["edges"][rows].long()
    return _edge_minmax(
        points[edges[:, 0]], points[edges[:, 1]],
        fc_base[td["edge_faces"][rows].long()],
        cell_ctrs[td["edge_cells"][rows].long()],
        td["edge_cell_f0"][rows], td["edge_cell_f1"][rows],
        td["edge_cells_mask"][rows], u_space)


def _per_edge(points, cell_ctrs, td, fc_base, u_space):
    """face_angles_for_edges over all edges, EVAL_CHUNK at a time."""
    parts = [face_angles_for_edges(points, cell_ctrs, td, fc_base, u_space,
                                   slice(s, s + EVAL_CHUNK))
             for s in range(0, td["edges"].shape[0], EVAL_CHUNK)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def current_face_angles_per_point(points, cell_ctrs, td, fc_base=None):
    """Per-point current min/max face angles in radians (reference
    calcCurrentMinMaxFaceAnglesForEdges + mapCurrentMinMaxFaceAnglesToPoints,
    src/smoothMesh.C:938-975, :1252-1270): the per-edge pass, then a
    gather over ``point_edges`` (a point's edges are exactly the edges
    containing it)."""
    if fc_base is None:
        fc_base = simple_face_centres(points, td)
    min_e, max_e = _per_edge(points, cell_ctrs, td, fc_base, False)
    valid = td["edge_valid"]
    min_e = torch.where(valid, min_e, TWO_PI)
    max_e = torch.where(valid, max_e, 0.0)
    pe = td["point_edges"].long()
    pm = td["point_edges_mask"]
    return (torch.where(pm, min_e[pe], TWO_PI).amin(1),
            torch.where(pm, max_e[pe], 0.0).amax(1))


def edge_face_angles_plain(points, means, cell_ctrs, td):
    """K5's plain version: (E, 2) [u_min | u_max] per edge."""
    return torch.stack(_per_edge(points, cell_ctrs, td, means, True), 1)


def point_face_angles_plain(edge_u, td):
    """K6's plain version: (N, 2) [u_min | u_max] per point over its
    edges; 4 and 0 where a point has no valid edge."""
    pe = td["point_edges"].long()
    pm = td["point_edges_mask"]
    return torch.stack([torch.where(pm, edge_u[pe, 0], 4.0).amin(1),
                        torch.where(pm, edge_u[pe, 1], 0.0).amax(1)], 1)


def edge_face_angles(points, means, cell_ctrs, td):
    """Per-edge u-space min/max face angle (K5): -> (E, 2) float.  On
    the card the kernel reads the cell slots as ``td["edge_cell_words"]``
    (:func:`smoothmesh_torch.device.pack_edge_cells`), not
    ``edge_cell_f0``, ``edge_cell_f1`` and ``edge_cells_mask``."""
    dev = points.device
    if not kernels.takes_kernel(dev, points.dtype, "edge_face_angles"):
        return edge_face_angles_plain(points, means, cell_ctrs, td)
    edges, ef, ec = td["edges"], td["edge_faces"], td["edge_cells"]
    words = td["edge_cell_words"]
    n_edges, wf = ef.shape
    wc = ec.shape[1]
    kernels.check(points, "points", torch.float32, (points.shape[0], 3), dev)
    kernels.check(means, "means", torch.float32, (means.shape[0], 3), dev)
    kernels.check(cell_ctrs, "cell_ctrs", torch.float32,
                  (cell_ctrs.shape[0], 3), dev)
    kernels.check(edges, "edges", torch.int32, (n_edges, 2), dev)
    kernels.check(ef, "edge_faces", torch.int32, (n_edges, wf), dev)
    kernels.check(ec, "edge_cells", torch.int32, (n_edges, wc), dev)
    kernels.check(words, "edge_cell_words", torch.int16, (n_edges, wc), dev)
    out = torch.empty((n_edges, 2), dtype=torch.float32, device=dev)
    kernels.FACE_ANGLES.launch(
        points.data_ptr(), means.data_ptr(), cell_ctrs.data_ptr(),
        edges.data_ptr(), ef.data_ptr(), ec.data_ptr(), words.data_ptr(),
        n_edges, wf, wc, out.data_ptr(), device=out.device)
    return out


def point_face_angles(edge_u, td):
    """Per-point min/max of the per-edge u values (K6): -> (N, 2)."""
    dev = edge_u.device
    if not kernels.takes_kernel(dev, edge_u.dtype, "point_face_angles"):
        return point_face_angles_plain(edge_u, td)
    pe, pm = td["point_edges"], td["point_edges_mask"]
    n, we = pe.shape
    kernels.check(edge_u, "edge_u", torch.float32, (td["edges"].shape[0], 2),
                  dev)
    kernels.check(pe, "point_edges", torch.int32, (n, we), dev)
    kernels.check(pm, "point_edges_mask", torch.bool, (n, we), dev)
    out = torch.empty((n, 2), dtype=torch.float32, device=dev)
    kernels.POINT_FACE_ANGLES.launch(edge_u.data_ptr(), pe.data_ptr(),
                                     pm.data_ptr(), n, we, out.data_ptr(),
                                     device=out.device)
    return out


def face_angles_per_point(points, means, cell_ctrs, td):
    """Current per-point min/max face angles in u space, from the face
    vertex means (K1) and the cell centres (K2): K5 then K6 on float32
    CUDA tensors, their plain versions on CPU tensors and float64 CUDA
    tensors -> (u_min, u_max)."""
    up = point_face_angles(edge_face_angles(points, means, cell_ctrs, td),
                           td)
    return up[:, 0], up[:, 1]


def face_angles_per_point_plain(points, means, cell_ctrs, td):
    up = point_face_angles_plain(
        edge_face_angles_plain(points, means, cell_ctrs, td), td)
    return up[:, 0], up[:, 1]


class FaceAngleBand(NamedTuple):
    """The face-angle fixed point's decision of which points it visits."""

    active: torch.Tensor    # (N,) bool: current angles outside the band
    min_angle: float        # the thresholds in the values' space
    max_angle: float
    det_eps: float          # the guard against last-bit "deteriorations"


def face_angle_band(cur_min, cur_max, min_angle_rad, max_angle_rad,
                    u_space=False, guarded=False,
                    eligible=None) -> FaceAngleBand:
    """The points the face-angle fixed point visits: current min angle
    <= min_angle or current max >= max_angle (the reference skips the
    others, src/smoothMesh.C:1367).  ``u_space``: the values are u
    values, so the thresholds map to u; ``guarded``: the current values
    come from another arithmetic path than the fixed point's (K5/K6),
    so deteriorations below ``det_eps`` = 1e-5 u are ignored.
    ``eligible``: (N,) bool or None; under the halo decomposition only
    the points with a complete local stencil (the owned ones) may be
    active.  No host read: the batched driver counts ``active`` on the
    device."""
    if u_space:
        min_angle_rad = angle_to_u(min_angle_rad)
        max_angle_rad = angle_to_u(max_angle_rad)
    det_eps = 1e-5 if (u_space and guarded) else 0.0
    active = (cur_min <= min_angle_rad) | (cur_max >= max_angle_rad)
    if eligible is not None:
        active = active & eligible
    return FaceAngleBand(active, min_angle_rad, max_angle_rad, det_eps)


def restrict_face_angle_deterioration(points, cell_ctrs, proposed, td,
                                      min_angle_rad, max_angle_rad, frozen,
                                      fc_base=None, cur_minmax=None,
                                      u_space=False, stats=None,
                                      eligible=None):
    """Freeze points (and neighbours) whose moves deteriorate face-face
    angles already outside [min_angle, max_angle] -> the freeze mask.

    The parallel fixed point of the reference's stack propagation
    (src/smoothMesh.C:1320-1437), as the JAX function computes it:

    1. active points (:func:`face_angle_band`): current min angle <=
       min_angle or current max >= max_angle (the reference skips the
       others, :1367);
    2. self phase, under the incoming mask: an active, moving, unfrozen
       point p freezes if p alone at its proposal deteriorates its own
       angles;
    3. pair sweeps: each active point p, at its effective position
       (current if frozen, else proposed), freezes each moving unfrozen
       neighbour q whose proposal, substituted, deteriorates p's
       angles.  A sweep evaluates from the mask at its start; sweeps
       repeat until no point newly freezes.

    "Deteriorates": the new min falls below both min_angle and the
    current min (less ``det_eps``), or the new max rises above both
    max_angle and the current max (plus ``det_eps``).  p's evaluations
    depend on the mask only through p's own state, so after the first
    pair pass only newly frozen active points are evaluated again: the
    same fixed point as a full re-evaluation each sweep.

    ``fc_base``: the face vertex means (K1's ``means``), else computed.
    ``cur_minmax``: current per-point (min, max), else the plain
    per-edge pass in angle space.  ``u_space``: all angle values are u
    values (cur_minmax from K5/K6); the thresholds map along, and since
    current and substituted values then come from two arithmetic paths,
    ``det_eps`` = 1e-5 u ignores sub-noise "deteriorations" (0 on one
    path).  ``stats``: a dict that receives the active-point count and
    the number of pair sweeps.  ``eligible``: (N,) bool or None; under
    the halo decomposition only the owned points (complete local
    stencils) may be active, and the freezes they make, of themselves
    or of any neighbour, are OR-combined across shards by the caller.

    Costs one host read when no point is active; otherwise one per
    phase and sweep.
    """
    dtype = points.dtype
    if fc_base is None:
        fc_base = simple_face_centres(points, td)
    if cur_minmax is None:
        cur_min, cur_max = current_face_angles_per_point(
            points, cell_ctrs, td, fc_base)
    else:
        cur_min, cur_max = cur_minmax
    active, min_angle_rad, max_angle_rad, det_eps = face_angle_band(
        cur_min, cur_max, min_angle_rad, max_angle_rad, u_space,
        guarded=cur_minmax is not None, eligible=eligible)
    act_idx = torch.nonzero(active).squeeze(1)           # host read
    if stats is not None:
        stats.update(active=act_idx.numel(), sweeps=0)
    if act_idx.numel() == 0:
        return frozen

    thr_mn = (cur_min - det_eps).clamp(max=min_angle_rad)
    thr_mx = (cur_max + det_eps).clamp(min=max_angle_rad)
    moving = (proposed != points).any(-1)
    inv_fn = 1.0 / td["face_npoints"].to(dtype).clamp_min(1.0)
    edges = td["edges"].long()
    n_edges = edges.shape[0]
    pe_flat = td["pe_flat"].long()
    pps = td["pps_signed"].long()
    ef, ec = td["edge_faces"].long(), td["edge_cells"].long()
    fpts, fmask = td["face_points"].long(), td["face_mask"]
    frozen = frozen.clone()

    def det(idx, pair):
        """(K,) self or (K, WP) pair deterioration bits of points idx."""
        pf = pe_flat[idx]                                # (K, WE)
        ok = pf >= 0
        pf = pf.clamp_min(0)
        e = pf % n_edges
        first = pf < n_edges                 # p is the edge's first end
        other = torch.where(first, edges[e, 1], edges[e, 0])
        cur_p = points[idx]
        eff_p = torch.where(frozen[idx, None], cur_p, proposed[idx])
        fids = ef[e]                                     # (K, WE, WF)
        ifn = inv_fn[fids]
        fc = fc_base[fids] + (eff_p - cur_p)[:, None, None, :] * ifn[..., None]
        cc = cell_ctrs[ec[e]]                            # (K, WE, WC, 3)
        f0, f1 = td["edge_cell_f0"][e], td["edge_cell_f1"][e]
        cm = td["edge_cells_mask"][e]
        p_eff, end_o = eff_p[:, None, :], points[other]
        lo, hi = thr_mn[idx][:, None], thr_mx[idx][:, None]
        if pair:
            q = pps[idx]                                 # (K, WP)
            q_ok = q >= 0
            qc = q.clamp_min(0)
            dq = torch.where(q_ok[..., None], proposed[qc] - points[qc],
                             0.0)                        # (K, WP, 3)
            q_o = (q_ok[:, None, :] & (q[:, None, :] == other[..., None]))
            end_o = (end_o[:, :, None, :]
                     + q_o.to(dtype)[..., None] * dq[:, None])
            in_q = ((fpts[fids][:, :, None] == q[:, None, :, None, None])
                    & fmask[fids][:, :, None]).any(-1) \
                & q_ok[:, None, :, None]                 # (K, WE, WP, WF)
            in_q = in_q.to(dtype) * ifn[:, :, None, :]
            fc = fc[:, :, None] + in_q[..., None] * dq[:, None, :, None, :]
            cc, f0, f1, cm = (cc[:, :, None], f0[:, :, None],
                              f1[:, :, None], cm[:, :, None])
            p_eff, first, ok = p_eff[:, None], first[..., None], ok[..., None]
            lo, hi = lo[..., None], hi[..., None]
        e0 = torch.where(first[..., None], p_eff, end_o)
        e1 = torch.where(first[..., None], end_o, p_eff)
        mn, mx = _edge_minmax(e0, e1, fc, cc, f0, f1, cm, u_space)
        return (((mn < lo) | (mx > hi)) & ok).any(1)

    def det_chunked(idx, pair):
        width = pe_flat.shape[1] * (pps.shape[1] if pair else 1)
        k = max(1, EVAL_CHUNK // max(width, 1))
        return torch.cat([det(idx[s:s + k], pair)
                          for s in range(0, max(idx.numel(), 1), k)])

    # self phase, run to completion before any pair evaluation
    cand = act_idx[moving[act_idx] & ~frozen[act_idx]]
    frozen[cand[det_chunked(cand, False)]] = True

    # pair sweeps to the fixed point
    todo, sweeps = act_idx, 0
    while todo.numel():
        q = pps[todo]
        qc = q.clamp_min(0)
        bad = det_chunked(todo, True) & (q >= 0) & moving[qc] & ~frozen[qc]
        newly = torch.unique(qc[bad])
        frozen[newly] = True
        sweeps += 1
        todo = newly[active[newly]]
    if stats is not None:
        stats["sweeps"] = sweeps
    return frozen
