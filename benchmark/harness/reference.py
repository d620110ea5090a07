"""The plain reference of one smoothing iteration (upstream smoothMesh,
src/smoothMesh.C:2257-2437), in plain PyTorch on any device and in any
float dtype, over the connectivity of :mod:`reftopo`.

Written from the algorithm, not from the program: OpenFOAM face and
cell geometry (fan and face-pyramid decompositions), centroidal
smoothing, the aspect-ratio blend of the two closest points, the step
limiter, the edge-shortening and edge-angle freezes, the face-angle
constraint as its least fixed point (the upstream stack propagation
reaches the same set in any order: a freeze only ever adds, and a
point's checks depend on the mask only through its own state), the
revert of frozen and fixed points and the residual.

Face angles are compared as u = 1 - cos(A + B) where A + B <= pi and
3 + cos(A + B) beyond (increasing in the angle, so every threshold
test is the angle's), and a deterioration counts only where it passes
the current value by more than 1e-5 in u: the program's stated
semantics (its float32 current angles come from another arithmetic
path than its substituted ones).
"""

from __future__ import annotations

import math

import torch

ACOS_CLAMP = 0.99999
U_GUARD = 1e-5
#: evaluations per chunk in the face-angle passes (bounds memory)
CHUNK = 1 << 17


def dot(a, b):
    return (a * b).sum(-1)


def norm(a):
    return torch.sqrt(dot(a, a))


#: upstream smoothMesh's option defaults (README.md:59-130)
DEFAULTS = dict(rel_step_frac=0.5, total_min_freeze=False,
                edge_angle_constraint=True, face_angle_constraint=True,
                min_angle=35.0, max_angle=160.0,
                layer_max_blending_fraction=0.3, layer_expansion_ratio=1.3,
                min_layers=1, max_layers=4, layer_patches=(),
                smoothing_patches=(".*",),
                internal_smoothing_blending_fraction=0.0)


def resolve(params: dict, mesh_min_edge: float) -> dict:
    """The options over the upstream defaults, with the derived ones
    (src/smoothMesh.C:1854-1921) from the start mesh's minimum edge
    length; angles in radians."""
    p = dict(DEFAULTS, **params)
    p.setdefault("min_edge_length", 0.5 * mesh_min_edge)
    p.setdefault("max_step_length", 0.3 * p["min_edge_length"])
    p.setdefault("layer_edge_length", p["min_edge_length"])
    p["distance_tolerance"] = 1e-4 * min(mesh_min_edge,
                                         p["layer_edge_length"])
    p["min_angle_rad"] = math.radians(p["min_angle"])
    p["max_angle_rad"] = math.radians(p["max_angle"])
    return p


def min_edge_length(x, T) -> float:
    e = T["edges"]
    return float(norm(x[e[:, 0]] - x[e[:, 1]]).min())


def face_geometry(x, T):
    """-> (area-weighted centres, area vectors, vertex means) per face."""
    m = T["face_mask"][..., None].to(x.dtype)
    p = x[T["face_points"].clamp_min(0)]
    q = x[T["face_next"].clamp_min(0)]
    vm = (p * m).sum(1) / T["face_npoints"][:, None].to(x.dtype)
    c = p + q + vm[:, None]
    nv = torch.linalg.cross(q - p, vm[:, None] - p, dim=-1)
    a = norm(nv)[..., None] * m
    sum_a = a.sum(1)
    good = sum_a > 1e-18
    centres = torch.where(good, (a * c).sum(1) / (3.0 * sum_a.clamp_min(
        1e-30)), vm)
    areas = torch.where(good, 0.5 * (nv * m).sum(1), 0.0)
    return centres, areas, vm


def cell_centres(fc, fa, T):
    cf = T["cell_faces"].clamp_min(0)
    m = T["cf_mask"].to(fc.dtype)
    f_c, f_a = fc[cf], fa[cf]
    est = (f_c * m[..., None]).sum(1) / m.sum(1, keepdim=True)
    pyr = T["cell_sign"].to(fc.dtype) * dot(f_a, f_c - est[:, None]) * m
    vol = pyr.sum(1)
    num = (pyr[..., None] * (0.75 * f_c + 0.25 * est[:, None])).sum(1)
    good = vol.abs() > 1e-30
    return torch.where(good[:, None],
                       num / torch.where(good, vol, 1.0)[:, None], est)


def centroidal(x, cc, T, do_boundary: bool):
    eligible = T["internal"] | do_boundary
    w = (T["pc_mask"] & eligible[:, None]).to(x.dtype)
    s = (cc[T["point_cells"].clamp_min(0)] * w[..., None]).sum(1)
    n = w.sum(1)
    return torch.where((n > 0)[:, None], s / n.clamp_min(1.0)[:, None], x)


def aspect_ratio_blend(x, cent, T):
    """Blend in the midpoint of the two closest edge neighbours (upstream
    src/smoothMesh.C:313-593): boundary points consider only boundary
    neighbours; no blend where the two closest share a cell."""
    pp = T["point_points"].clamp_min(0)
    internal = T["internal"]
    ok = T["pp_mask"] & (internal[:, None] | ~internal[pp])
    rel = x[pp] - x[:, None]
    length = torch.where(ok, norm(rel), math.inf)
    k = min(3, length.shape[1])
    ln, slot = torch.topk(length, k, dim=1, largest=False, sorted=True)
    nid = torch.gather(pp, 1, slot)
    c1 = torch.gather(rel, 1, slot[:, :1, None].expand(-1, 1, 3))[:, 0]
    c2 = torch.gather(rel, 1, slot[:, 1:2, None].expand(-1, 1, 3))[:, 0]
    l1, l2 = ln[:, 0], ln[:, 1]
    l3 = ln[:, 2] if k > 2 else torch.full_like(l1, math.inf)
    l3 = torch.where(torch.isfinite(l3), l3, 1e30)
    two = torch.isfinite(l2)
    pc, pm = T["point_cells"], T["pc_mask"]
    a, b = nid[:, 0], nid[:, 1]
    share = ((pc[a][:, :, None] == pc[b][:, None, :])
             & pm[a][:, :, None] & pm[b][:, None, :]).flatten(1).any(1)
    r1 = l2 / l1
    r2 = l3 / l2
    f_int = torch.where((r1 < 1.5) & (r2 > 1.5),
                        ((r2 - 1.5) / 1.5).clamp(0.0, 1.0), 0.0)
    f_bnd = (r1 - 1.0).clamp(0.0, 1.0)
    frac = torch.where(internal, f_int, f_bnd)
    frac = torch.where(two & ~share, frac, 0.0)
    frac = torch.nan_to_num(frac, nan=0.0)
    mid = x + 0.5 * (c1 + c2)
    out = (1.0 - frac)[:, None] * cent + frac[:, None] * mid
    return torch.where((frac > 0)[:, None], out, cent)


def limit_step(x, prop, max_step, rel_frac):
    step = prop - x
    ln = norm(step)
    scale = torch.where(ln > max_step,
                        max_step / (ln.clamp_min(1e-30) * rel_frac), 1.0)
    return x + (rel_frac * scale)[:, None] * step


def angle(c, p1, p2):
    v1, v2 = p1 - c, p2 - c
    cos = dot(v1, v2) / (norm(v1) * norm(v2)).clamp_min(1e-30)
    return torch.arccos(cos.clamp(-ACOS_CLAMP, ACOS_CLAMP))


def freezes(x, prop, T, p):
    """Edge-shortening (src/smoothMesh.C:602-652) and edge-angle
    (:837-930) freezes -> (N,) bool."""
    pp = T["point_points"].clamp_min(0)
    m = T["pp_mask"]
    cur = torch.where(m, norm(x[pp] - x[:, None]), math.inf).amin(1)
    new = torch.where(m, norm(x[pp] - prop[:, None]), math.inf).amin(1)
    if p["total_min_freeze"]:
        fr = torch.minimum(cur, new) < p["min_edge_length"]
    else:
        fr = (new < p["min_edge_length"]) & (new < cur)
    if p["edge_angle_constraint"]:
        a, b = T["wedge_prev"].clamp_min(0), T["wedge_next"].clamp_min(0)
        x0, xa, xb = x[:, None].expand_as(x[a]), x[a], x[b]
        q0 = prop[:, None].expand_as(xa)
        qa, qb = prop[a], prop[b]
        c = angle(x0, xa, xb)
        n = torch.minimum(torch.minimum(angle(q0, xa, xb), angle(q0, qa, qb)),
                          torch.minimum(angle(q0, xa, qb), angle(q0, qa, xb)))
        wm = T["pf_mask"]
        min_c = torch.where(wm, c, math.inf).amin(1)
        min_n = torch.where(wm, n, math.inf).amin(1)
        fr = fr | ((min_n < p["min_angle_rad"]) & (min_n < min_c))
    return fr


def _u(a, b):
    """The face-angle pair's u value from its two clamped cosines."""
    s = (torch.arccos(a.clamp(-ACOS_CLAMP, ACOS_CLAMP))
         + torch.arccos(b.clamp(-ACOS_CLAMP, ACOS_CLAMP)))
    return torch.where(s <= math.pi, 1.0 - torch.cos(s), 3.0 + torch.cos(s))


def _unit_proj(y, ctr, ev):
    d = y + dot(ctr - y, ev)[..., None] * ev - ctr
    return d / norm(d)[..., None].clamp_min(1e-30)


def edge_minmax(e0, e1, fa, fb, cc, cmask):
    """Min and max over an edge's cells (last axis but one of fa, fb, cc)
    of the face-face angle in u (upstream calcMinMaxFaceAngleForEdge,
    src/smoothMesh.C:1135-1231): the two faces' vertex means and the
    cell centre projected onto the plane normal to the edge through its
    midpoint."""
    ctr = 0.5 * (e0 + e1)
    ev = e1 - e0
    ev = (ev / norm(ev)[..., None].clamp_min(1e-30))[..., None, :]
    ctr = ctr[..., None, :]
    cv = _unit_proj(cc, ctr, ev)
    u = _u(dot(_unit_proj(fa, ctr, ev), cv), dot(cv, _unit_proj(fb, ctr, ev)))
    return (torch.where(cmask, u, 4.0).amin(-1),
            torch.where(cmask, u, 0.0).amax(-1))


def current_face_angles(x, cc, means, T):
    """Per point: the min and max face angle (u) over its edges."""
    e, ec = T["edges"], T["edge_cells"].clamp_min(0)
    mins, maxs = [], []
    for s in range(0, e.shape[0], CHUNK):
        sl = slice(s, s + CHUNK)
        mn, mx = edge_minmax(x[e[sl, 0]], x[e[sl, 1]],
                             means[T["edge_cf0"][sl].clamp_min(0)],
                             means[T["edge_cf1"][sl].clamp_min(0)],
                             cc[ec[sl]], T["ec_mask"][sl])
        mins.append(mn)
        maxs.append(mx)
    mn, mx = torch.cat(mins), torch.cat(maxs)
    pe, pm = T["point_edges"].clamp_min(0), T["pe_mask"]
    return (torch.where(pm, mn[pe], 4.0).amin(1),
            torch.where(pm, mx[pe], 0.0).amax(1))


def _point_minmax(x, cc, means, T, pts, subs):
    """Min/max face angle (u) of the points ``pts`` (shape S) over their
    edges, with each (point id, coordinates) of ``subs`` (ids of shape
    S, coordinates S + (3,)) substituted into the edge ends and the face
    vertex means (cell centres stay current)."""
    pe = T["point_edges"][pts]                       # S + (WE,)
    ok = pe >= 0
    e = pe.clamp_min(0)
    ends = T["edges"][e]                             # S + (WE, 2)
    f = torch.stack([T["edge_cf0"][e], T["edge_cf1"][e]], -1).clamp_min(0)
    fp = T["face_points"][f]                         # S + (WE, WC, 2, WF)
    inv_n = 1.0 / T["face_npoints"][f].to(x.dtype)
    pos = x[ends]                                    # S + (WE, 2, 3)
    fm = means[f]                                    # S + (WE, WC, 2, 3)
    for sid, sx in subs:
        d = (sx - x[sid])[..., None, None, None, :]
        pos = torch.where((ends == sid[..., None, None])[..., None],
                          sx[..., None, None, :], pos)
        hit = (fp == sid[..., None, None, None, None]).any(-1)
        fm = fm + (hit.to(x.dtype) * inv_n)[..., None] * d
    cm = T["ec_mask"][e] & ok[..., None]
    mn, mx = edge_minmax(pos[..., 0, :], pos[..., 1, :], fm[..., 0, :],
                         fm[..., 1, :], cc[T["edge_cells"][e].clamp_min(0)],
                         cm)
    mn = torch.where(ok, mn, 4.0).amin(-1)
    mx = torch.where(ok, mx, 0.0).amax(-1)
    return mn, mx


def face_angle_fixed_point(x, prop, cc, means, T, p, frozen):
    """The face-angle constraint (upstream src/smoothMesh.C:938-1437) as
    its least fixed point -> the freeze mask.  Points whose current min
    angle is at or below min_angle or max at or above max_angle are
    active; an active moving point freezes if its own move deteriorates
    its angles; each active point, at its position (current if frozen,
    else proposed), freezes each moving unfrozen neighbour whose move
    deteriorates its angles; a point frozen so is checked again as an
    active point, until nothing more freezes."""
    cur_min, cur_max = current_face_angles(x, cc, means, T)
    lo_u = 1.0 - math.cos(p["min_angle_rad"])
    hi_u = 1.0 - math.cos(p["max_angle_rad"])
    active = (cur_min <= lo_u) | (cur_max >= hi_u)
    act = torch.nonzero(active).squeeze(1)
    if act.numel() == 0:
        return frozen
    thr_lo = (cur_min - U_GUARD).clamp(max=lo_u)
    thr_hi = (cur_max + U_GUARD).clamp(min=hi_u)
    moving = (prop != x).any(-1)
    frozen = frozen.clone()

    def worse(pts, mn, mx):
        return (mn < thr_lo[pts]) | (mx > thr_hi[pts])

    cand = act[moving[act] & ~frozen[act]]
    for s in range(0, cand.numel(), CHUNK // 8):
        c = cand[s:s + CHUNK // 8]
        mn, mx = _point_minmax(x, cc, means, T, c, [(c, prop[c])])
        frozen[c[worse(c, mn, mx)]] = True

    pp = T["point_points"]
    todo = act
    while todo.numel():
        newly = []
        step = max(1, CHUNK // (8 * pp.shape[1]))
        for s in range(0, todo.numel(), step):
            t = todo[s:s + step]
            q = pp[t]                                     # (K, WP)
            qc = q.clamp_min(0)
            eff = torch.where(frozen[t, None], x[t], prop[t])
            tt = t[:, None].expand_as(q)
            mn, mx = _point_minmax(
                x, cc, means, T, tt,
                [(tt, eff[:, None].expand(q.shape + (3,))), (qc, prop[qc])])
            bad = worse(tt, mn, mx) & (q >= 0) & moving[qc] & ~frozen[qc]
            newly.append(qc[bad])
        newly = torch.unique(torch.cat(newly))
        newly = newly[~frozen[newly]]
        frozen[newly] = True
        todo = newly[active[newly]]
    return frozen


def iteration(x, T, p, dtype=torch.float64):
    """One iteration of the internal smoother (boundary points fixed)
    from points ``x``, in ``dtype`` -> (new points, residual)."""
    x = x.to(dtype)
    fc, fa, means = face_geometry(x, T)
    cc = cell_centres(fc, fa, T)
    prop = centroidal(x, cc, T, False)
    prop = aspect_ratio_blend(x, prop, T)
    prop = limit_step(x, prop, p["max_step_length"], p["rel_step_frac"])
    frozen = freezes(x, prop, T, p)
    if p["face_angle_constraint"]:
        frozen = face_angle_fixed_point(x, prop, cc, means, T, p, frozen)
    new = torch.where((frozen | ~T["internal"])[:, None], x, prop)
    res = float(norm(new - x).max()) / p["max_step_length"]
    return new, res
