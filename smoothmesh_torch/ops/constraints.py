"""Quality-constraint freezes (the reference's L5 layer), this slice's
part:

  - ``restrict_edge_shortening``          (reference src/smoothMesh.C:602-652)
  - ``restrict_min_edge_angle_decrease``  (reference src/smoothMesh.C:766-930)

Each returns an updated boolean freeze mask; frozen points revert to
their current coordinates at the end of the iteration (reference
src/smoothMesh.C:2384-2392).  The two functions are the reference's
clamped-acos formulation; :func:`freeze_constraints` is the fused stage
the driver calls, which compares clamped cosines instead (acos is
strictly decreasing, so every angle comparison maps to the reversed
cosine comparison): the plain version for CPU tensors, the hand-written
kernel ``csrc/freeze.cu`` (K4, float32) for CUDA tensors.

The face-angle constraint (``restrictFaceAngleDeterioration``) arrives
with the next slice of the port.
"""

from __future__ import annotations

import math

import torch

from smoothmesh_torch import kernels
from smoothmesh_torch.geometry import dot3, norm3

VSMALL = 1e-30
ACOS_CLAMP = 0.99999


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
    """The fused freeze stage (K4): -> (N,) bool freeze mask."""
    dev = points.device
    if dev.type == "cpu":
        return freeze_constraints_plain(
            points, proposed, td, min_edge_length, total_min_freeze,
            min_angle_rad, edge_angle_constraint, frozen)
    if dev.type != "cuda":
        raise ValueError(f"freeze_constraints: no kernel for {dev}")
    n = points.shape[0]
    pp, ppm = td["point_points"], td["point_points_mask"]
    pfm, wprev, wnext = (td["point_faces_mask"], td["wedge_prev"],
                         td["wedge_next"])
    wp, wf = pp.shape[1], pfm.shape[1]
    kernels.check(points, "points", torch.float32, (n, 3), dev)
    kernels.check(proposed, "proposed", torch.float32, (n, 3), dev)
    kernels.check(pp, "point_points", torch.int32, (n, wp), dev)
    kernels.check(ppm, "point_points_mask", torch.bool, (n, wp), dev)
    kernels.check(pfm, "point_faces_mask", torch.bool, (n, wf), dev)
    kernels.check(wprev, "wedge_prev", torch.int32, (n, wf), dev)
    kernels.check(wnext, "wedge_next", torch.int32, (n, wf), dev)
    kernels.check(frozen, "frozen", torch.bool, (n,), dev)
    out = torch.empty((n,), dtype=torch.bool, device=dev)
    kernels.FREEZE.launch(
        points.data_ptr(), proposed.data_ptr(), pp.data_ptr(),
        ppm.data_ptr(), pfm.data_ptr(), wprev.data_ptr(), wnext.data_ptr(),
        frozen.data_ptr(), n, wp, wf, float(min_edge_length),
        int(bool(total_min_freeze)), math.cos(min_angle_rad),
        int(bool(edge_angle_constraint)), out.data_ptr())
    return out
