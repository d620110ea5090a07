"""The plain reference of the boundary path: boundary-layer blending
(upstream src/orthogonalBoundaryBlending.C) and boundary point
smoothing (src/boundaryPointSmoothing.C), set up from the inputs alone
and run one iteration at a time on top of :mod:`reference`.

Set-up: each point's classifying patch (its lowest-numbered boundary
face's), the points connected to the interior, the hop counts to the
layer and smoothing patches, the outward and inward prismatic maps
with the start mesh's boundary normals carried inward along them, the
corner and feature points of the edge ring with their targets and edge
strings, and the target triangles.  Layers without boundary smoothing
(no target) set up the layer tables alone: the hops to the layer
patches, the outward map and the normals.

The iteration calls the step limiter three times, as upstream does
(src/smoothMesh.C:2257-2356): after the predictor, after the layer
blend, after the boundary projection (twice without boundary
smoothing, which skips the projection).  The first call leaves every
limited point's step exactly maxStepLength long, on the limiter's
discontinuity, so at the later calls the last bits of the arithmetic
decide between keeping the step and halving it; upstream's float64 and
the program's float32 decide differently.  The reference follows both
branches at each such point and returns the four candidates of each
point (two without boundary smoothing); the check accepts the
nearest.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch

from harness import reference as ref

BIG = 1e18
ABS_TOL = 1e-6
REL_TOL = 1e-4
#: relative distance from maxStepLength within which a step sits on the
#: limiter's discontinuity
KNIFE = 1e-5
BARY = 1e-9
DET_EPS = 1e-12
RAY_CHUNK = 1024


def _matching(names, selectors) -> list:
    return [i for i, n in enumerate(names)
            if any(s == n or re.fullmatch(s, n) for s in selectors)]


def _hops(T, seed, max_iter):
    """Hops to the seed points through internal points (upstream
    calculatePointHopsToBoundary, oBB.C:52-134: an internal point takes
    its highest neighbour's count plus one)."""
    pp, pm, internal = T["point_points"].clamp_min(0), T["pp_mask"], \
        T["internal"]
    hops = torch.where(seed, 0, -1)
    for _ in range(max_iter):
        nb = torch.where(pm, hops[pp], -1).amax(1)
        grow = (hops < 0) & internal & (nb >= 0)
        hops = torch.where(grow, nb + 1, hops)
    return hops


def _last_match(match, pp):
    """Per row: the neighbour of the last matching slot (0 where none)."""
    w = match.shape[1]
    slot = torch.where(match, torch.arange(w, device=pp.device), -1).amax(1)
    return torch.gather(pp, 1, slot.clamp_min(0)[:, None])[:, 0]


def accumulate_normals(prev, fa, T, real_face):
    """The boundary point normals' update (oBB.C:141-233): the previous
    field plus the inward unit normals of the point's real boundary
    faces; sharp where the sum is shorter than 0.1 (zeroed), else
    normalized -> (normals, is_sharp)."""
    unit = fa / ref.norm(fa)[:, None].clamp_min(1e-30)
    pf = T["point_faces"].clamp_min(0)
    sel = T["pf_mask"] & real_face[pf]
    add = -(unit[pf] * sel[..., None].to(fa.dtype)).sum(1)
    n_faces = sel.sum(1)
    normals = prev + add
    mag = ref.norm(normals)
    sharp = (n_faces >= 1) & (mag < 0.1)
    normals = torch.where(sharp[:, None], 0.0, normals)
    scale = (mag > 0) & ~sharp
    normals = torch.where(scale[:, None],
                          normals / mag.clamp_min(1e-300)[:, None], normals)
    return normals, sharp


def _edge_strings(n_pts: int, edges: np.ndarray) -> np.ndarray:
    """Edge strings: edges joined at vertices of valence 2 (upstream
    findEdgeMeshStrings, bPS.C:446-587)."""
    valence = np.bincount(edges.ravel(), minlength=n_pts)
    parent = list(range(len(edges)))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    by_vertex = {}
    for e, (a, b) in enumerate(edges):
        for v in (a, b):
            if valence[v] == 2:
                by_vertex.setdefault(v, []).append(e)
    for es in by_vertex.values():
        for e in es[1:]:
            parent[find(e)] = find(es[0])
    roots = [find(e) for e in range(len(edges))]
    ids = {r: i for i, r in enumerate(dict.fromkeys(roots))}
    return np.array([ids[r] for r in roots], dtype=np.int64)


def _closest_on_edges(q, ea, eb, strings=None, want=None):
    """Each query point's clipped projection onto the edges (upstream
    projectPointToEdge, bPS.C:89-145), the nearest kept (first on a
    tie), optionally among the edges of string ``want`` -> (projection,
    edge index, unclipped foot, parameter)."""
    ab = eb - ea
    ll = ref.dot(ab, ab).clamp_min(1e-300)
    ndp = ref.dot(q[:, None] - ea[None], ab[None]) / ll[None]
    free = ea[None] + ndp[..., None] * ab[None]
    proj = torch.where((ndp <= ABS_TOL)[..., None], ea[None],
                       torch.where((ndp >= 1 - ABS_TOL)[..., None],
                                   eb[None], free))
    dist = ref.norm(proj - q[:, None])
    if want is not None:
        dist = torch.where((want[:, None] < 0)
                           | (strings[None] == want[:, None]), dist,
                           math.inf)
    i = torch.argmin(dist, 1)
    r = torch.arange(q.shape[0], device=q.device)
    return proj[r, i], i, free[r, i], ndp[r, i]


def setup(mesh: dict, T: dict, p: dict, target, device) -> dict:
    """The boundary path's tables from the inputs (upstream
    src/smoothMesh.C:2079-2249); where ``target`` is None (layers
    without boundary smoothing), the layer tables alone.  ``path``
    records which: ``boundary`` or ``layers``."""
    dev = torch.device(device)
    names = [name for name, _, _ in mesh["patches"]]
    n, x0 = T["n_points"], torch.as_tensor(mesh["points"], device=dev)
    internal = T["internal"]
    face_patch = torch.full((T["n_faces"],), -1, dtype=torch.int64,
                            device=dev)
    for i, (_, count, start) in enumerate(mesh["patches"]):
        face_patch[start:start + count] = i
    real_face = face_patch >= 0
    fp, fm = T["face_points"], T["face_mask"]

    # classifying patch: the patch of the point's lowest boundary face
    f_ids = torch.arange(T["n_faces"], device=dev)[:, None].expand_as(fp)
    sel = fm & real_face[:, None]
    first = torch.full((n,), T["n_faces"], dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, fp[sel], f_ids[sel], "amin")
    cpatch = torch.where(first < T["n_faces"],
                         face_patch[first.clamp(max=T["n_faces"] - 1)], -1)

    def ids_t(ids):
        return torch.tensor(ids, dtype=torch.int64, device=dev)

    def on_patches(ids):
        hit = torch.zeros(n, dtype=torch.bool, device=dev)
        hit[fp[sel & torch.isin(face_patch, ids_t(ids))[:, None]]] = True
        return hit

    layer_ids = _matching(names, p["layer_patches"])
    pp, pm = T["point_points"].clamp_min(0), T["pp_mask"]
    connected = ~internal & (pm & internal[pp]).any(1)
    hops_layer = _hops(T, on_patches(layer_ids) & connected,
                       p["max_layers"] + 1)
    layer_surface = ~internal & torch.isin(cpatch, ids_t(layer_ids))

    # the start mesh's normals, carried inward level by level along
    # the unique prismatic edges; a point claimed twice is invalid
    _, fa, _ = ref.face_geometry(x0, T)
    normals, _ = accumulate_normals(torch.zeros_like(x0), fa, T, real_face)
    outer = torch.full((n,), -1, dtype=torch.int64, device=dev)
    invalid = torch.zeros(n, dtype=torch.bool, device=dev)
    for lvl in range(1, p["max_layers"] + 2):
        low = pm & (hops_layer[pp] == lvl - 1)
        neigh = _last_match(low, pp)
        cand = ((hops_layer == lvl) & (low.sum(1) == 1)
                & (internal[neigh] | layer_surface[neigh]))
        claims = torch.bincount(neigh[cand], minlength=n)
        conflict = cand & (claims[neigh] >= 2)
        good = cand & ~conflict
        outer = torch.where(good, neigh, outer)
        normals = torch.where(good[:, None], normals[neigh], normals)
        invalid = invalid | (good & invalid[neigh]) | conflict
    normals = torch.where(invalid[:, None], 0.0, normals)
    outer = torch.where(invalid, -1, outer)
    # the internal points the layer blend moves (a blend above 0)
    layer = internal & (hops_layer >= 1) & (hops_layer <= p["max_layers"])
    tables = dict(path="layers", real_face=real_face, hops_layer=hops_layer,
                  outer=outer, normals_init=normals, connected=connected,
                  layer=layer)
    if target is None:
        return tables

    V, tris, ring_pts, ring_edges = target
    smooth_ids = _matching(names, p["smoothing_patches"])
    hops_smooth = _hops(T, on_patches(smooth_ids) & connected, 2)
    smoothing_surface = ~internal & torch.isin(cpatch, ids_t(smooth_ids))
    high = pm & (hops_smooth[pp] == 1)
    inner = torch.where(smoothing_surface & connected & (hops_smooth == 0)
                        & (high.sum(1) == 1), _last_match(high, pp), -1)

    # corners and feature points of the edge ring (the target ring is
    # the initial one)
    mesh_min = ref.min_edge_length(x0, T)
    tol = 1e-4 * min(mesh_min, p["layer_edge_length"])
    rp = torch.as_tensor(ring_pts, dtype=torch.float64, device=dev)
    re_ = torch.as_tensor(ring_edges, dtype=torch.int64, device=dev)
    valence = torch.bincount(re_.ravel(), minlength=len(ring_pts))
    strings = torch.as_tensor(_edge_strings(len(ring_pts), ring_edges),
                              device=dev)
    ea, eb = rp[re_[:, 0]], rp[re_[:, 1]]
    bnd = torch.nonzero(~internal & (cpatch >= 0)).squeeze(1)
    q = x0[bnd]
    proj, ei, free, ndp = _closest_on_edges(q, ea, eb)
    vert = torch.where((ndp <= ABS_TOL) & (ref.norm(free - ea[ei]) <= tol),
                       re_[ei, 0],
                       torch.where((ndp >= 1 - ABS_TOL)
                                   & (ref.norm(free - eb[ei]) <= tol),
                                   re_[ei, 1], -1))
    at_corner = (vert >= 0) & (valence[vert.clamp_min(0)] != 2)
    corner = torch.zeros(n, dtype=torch.bool, device=dev)
    feature = torch.zeros_like(corner)
    corner[bnd] = at_corner
    feature[bnd] = ~at_corner & (ref.norm(q - proj) < tol)
    corner_ids = torch.nonzero(valence != 2).squeeze(1)
    corner_target = torch.full_like(x0, 1e30)
    c_rows = torch.nonzero(corner).squeeze(1)
    if c_rows.numel():
        d = ref.norm(x0[c_rows][:, None] - rp[corner_ids][None])
        corner_target[c_rows] = rp[corner_ids[torch.argmin(d, 1)]]
    point_string = torch.full((n,), -1, dtype=torch.int64, device=dev)
    f_rows = torch.nonzero(feature).squeeze(1)
    if f_rows.numel():
        point_string[f_rows] = strings[_closest_on_edges(x0[f_rows], ea,
                                                         eb)[1]]
    feat_neigh = (pm & feature[:, None] & ~internal[pp] & ~feature[pp]
                  & ~corner[pp])
    tri = torch.as_tensor(np.asarray(V)[np.asarray(tris)],
                          dtype=torch.float64, device=dev)     # (Tr, 3, 3)
    return dict(tables, path="boundary", inner=inner,
                smoothing=smoothing_surface,    # on a smoothing patch
                corner=corner, feature=feature,
                corner_target=corner_target, point_string=point_string,
                feat_rows=f_rows, feat_neigh=feat_neigh,
                ring=(ea, eb, strings), tri=tri,
                max_dist=tol * (1.0 / REL_TOL) ** 4)


def ray_hits(o, d, tri, max_dist):
    """Nearest hit of each line o + t d with the triangles, t in
    [-max_dist, max_dist] (Moller-Trumbore; the + side on a tie) ->
    (hit points, found)."""
    a = tri[:, 0][None]
    e1 = (tri[:, 1] - tri[:, 0])[None]
    e2 = (tri[:, 2] - tri[:, 0])[None]
    hits, found = [], []
    for s in range(0, o.shape[0], RAY_CHUNK):
        oo, dd = o[s:s + RAY_CHUNK, None], d[s:s + RAY_CHUNK, None]
        pv = torch.linalg.cross(dd, e2, dim=-1)
        det = ref.dot(e1, pv)
        ok = det.abs() > DET_EPS
        inv = 1.0 / torch.where(ok, det, 1.0)
        sv = oo - a
        u = ref.dot(sv, pv) * inv
        qv = torch.linalg.cross(sv, e1, dim=-1)
        v = ref.dot(dd, qv) * inv
        t = ref.dot(e2, qv) * inv
        ok = ok & (u >= -BARY) & (v >= -BARY) & (u + v <= 1 + BARY)
        t = torch.where(ok, t, math.inf)
        tp = torch.where((t >= 0) & (t <= max_dist), t, math.inf).amin(1)
        tn = torch.where((t < 0) & (t >= -max_dist), -t, math.inf).amin(1)
        o1, d1 = oo[:, 0], dd[:, 0]
        hits.append(torch.where((tp <= tn)[:, None], o1 + tp[:, None] * d1,
                                o1 - tn[:, None] * d1))
        found.append(torch.isfinite(torch.minimum(tp, tn)))
    return torch.cat(hits), torch.cat(found)


def _limit_branches(x, prop, max_step, rel_frac):
    """The step limiter at a later call -> (halved where the step sits on
    the discontinuity, kept there), equal elsewhere."""
    gen = ref.limit_step(x, prop, max_step, rel_frac)
    knife = ((ref.norm(prop - x) / max_step) - 1.0).abs() <= KNIFE
    half = x + 0.5 * (prop - x)
    return (torch.where(knife[:, None], half, gen),
            torch.where(knife[:, None], prop, gen))


def iteration(x, normals_prev, T, B, p, dtype=torch.float64):
    """One boundary-path iteration from points ``x`` and the normals'
    state -> (candidates (4, N, 3), reverted (N,), new normals); with
    the layer tables alone (:func:`setup` without a target), the layer
    path's: two candidates, boundary points fixed."""
    x = x.to(dtype)
    smoothing = B["path"] == "boundary"     # else layers alone
    fc, fa, means = ref.face_geometry(x, T)
    normals, sharp = accumulate_normals(normals_prev.to(dtype), fa, T,
                                        B["real_face"])
    cc = ref.cell_centres(fc, fa, T)
    ms, rf = p["max_step_length"], p["rel_step_frac"]
    prop = ref.centroidal(x, cc, T, smoothing)
    prop = ref.aspect_ratio_blend(x, prop, T)
    prop = ref.limit_step(x, prop, ms, rf)

    # the layer blend (oBB.C:507-567, maxLayers with its call-site +1)
    internal = T["internal"]
    hops = B["hops_layer"]
    outer = torch.where((B["outer"] >= 0)[:, None],
                        x[B["outer"].clamp_min(0)], BIG)
    top = p["max_layers"] + 1
    ok = ((normals != 0).any(1) & internal & (hops >= 1)
          & (outer.abs() < 1e17).all(1))
    length = p["layer_edge_length"] * p["layer_expansion_ratio"] ** (
        (hops - 1).clamp(max=top).to(dtype))
    slope = -p["layer_max_blending_fraction"] / (top - p["min_layers"])
    blend = (-slope * top + slope * hops.to(dtype)).clamp(
        0.0, p["layer_max_blending_fraction"])
    ortho = outer + length[:, None] * normals
    prop = torch.where(ok[:, None], blend[:, None] * ortho
                       + (1.0 - blend[:, None]) * prop, prop)
    if not smoothing:
        # the limiter's second call ends the proposal, and every
        # boundary point stays
        cands = _limit_branches(x, prop, ms, rf)
        frozen = ref.freezes(x, cands[0], T, p)
        if p["face_angle_constraint"]:
            frozen = ref.face_angle_fixed_point(x, cands[0], cc, means, T,
                                                p, frozen)
        return torch.stack(cands), frozen | ~internal, normals

    # boundary projection (bPS.C:843-945) on each branch of the limiter;
    # the face-centroid blend of bPS.C:869-885 has the fixed fraction 0
    corner, feature = B["corner"], B["feature"]
    sums = torch.zeros_like(x)
    counts = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    rows = B["feat_rows"]
    if rows.numel():
        ea, eb, strings = B["ring"]
        fn = T["point_points"][rows].clamp_min(0)
        fm = B["feat_neigh"][rows]
        want = B["point_string"][rows][:, None].expand_as(fn)
        pr = _closest_on_edges(x[fn.reshape(-1)], ea.to(dtype), eb.to(dtype),
                               strings, want.reshape(-1))[0]
        sums[rows] = (pr.reshape(fn.shape + (3,))
                      * fm[..., None].to(dtype)).sum(1)
        counts[rows] = fm.sum(1)
    sharp_freeze = ~internal & sharp & ~corner & ~feature
    free = ~internal & B["smoothing"] & ~corner & ~feature & ~sharp_freeze
    f_rows = torch.nonzero(free).squeeze(1)
    inner = torch.where((B["inner"] >= 0)[:, None],
                        x[B["inner"].clamp_min(0)], BIG)
    prism = (B["smoothing"] & B["connected"] & (B["inner"] >= 0) & ~feature
             & ~corner & ~sharp & (normals != 0).any(1)
             & (inner.abs() < 1e17).all(1))
    f_int = p["internal_smoothing_blending_fraction"]
    cands, no_hit = [], None
    for q in _limit_branches(x, prop, ms, rf):
        out = torch.where((corner & ~internal)[:, None],
                          B["corner_target"].to(dtype), q)
        out = torch.where((feature & ~internal & (counts > 0))[:, None],
                          sums / counts.clamp_min(1)[:, None].to(dtype), out)
        hit, found = ray_hits(out[f_rows], normals[f_rows],
                              B["tri"].to(dtype), B["max_dist"])
        out[f_rows] = torch.where(found[:, None], hit, out[f_rows])
        if no_hit is None:          # the misses of the first branch
            no_hit = torch.zeros_like(free)
            no_hit[f_rows] = ~found
        # the prismatic projection (oBB.C:573-633)
        nv = out - inner
        pj = out - (nv - ref.dot(nv, normals)[:, None] * normals)
        out = torch.where(prism[:, None], f_int * pj + (1.0 - f_int) * out,
                          out)
        cands += _limit_branches(x, out, ms, rf)

    main = cands[0]
    frozen = sharp_freeze | no_hit | ref.freezes(x, main, T, p)
    if p["face_angle_constraint"]:
        frozen = ref.face_angle_fixed_point(x, main, cc, means, T, p, frozen)
    revert = frozen | (~internal & ~B["smoothing"])
    return torch.stack(cands), revert, normals
