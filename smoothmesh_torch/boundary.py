"""Boundary point smoothing: feature-edge/corner classification and
projection onto target surface/edge meshes (reference
src/boundaryPointSmoothing.C).

Host set-up (numpy, once; a copy of ``smoothmesh_tpu.boundary``):
  - edge-mesh sanity checks            (checkEdgeMeshSanity bPS.C:20-80)
  - edge-string labeling               (findEdgeMeshStrings :446-587,
                                        iterative instead of recursive)
  - boundary point classification      (classifyBoundaryPoints :269-441)
    incl. the reference's first-patch-wins quirk: a point shared by two
    patches is classified by the patch of its lowest-numbered boundary
    face
  - per-feature-point string ids       (src/smoothMesh.C:2234-2249)

Per iteration (plain PyTorch, except the ray cast):
  - feature-edge projections           (calculateFeatureEdgeProjections
                                        :623-677): neighbours projected
    onto string-filtered target edges, averaged
  - priority application + surface snap (projectBoundaryPointsToEdges-
    AndSurfaces :843-945): corner snap -> feature mean -> sharp freeze
    -> brute-force ray cast against the target triangles
    (``ops.raycast``: kernel K8 on CUDA tensors)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from smoothmesh_torch.geometry import dot3, norm3
from smoothmesh_torch.ops import raycast
from smoothmesh_torch.mesh.topology import MeshTopology
from smoothmesh_torch.params import ABS_TOL, REL_TOL

UNDEF = -1
#: faceCentroidBlendingFraction, fixed in the reference (bPS.C:876)
FACE_CENTROID_BLENDING_FRACTION = 0.0


# ---------------------------------------------------------------------------
# Host: edge-mesh utilities
# ---------------------------------------------------------------------------

def check_edge_mesh_sanity(points: np.ndarray, edges: np.ndarray,
                           mesh_min_edge: float, mesh_perimeter: float
                           ) -> None:
    """reference checkEdgeMeshSanity (bPS.C:20-80)."""
    if len(edges) == 0:
        raise ValueError("edge mesh has no edges")
    lengths = np.linalg.norm(points[edges[:, 1]] - points[edges[:, 0]],
                             axis=1)
    if lengths.min() < REL_TOL * mesh_min_edge:
        raise ValueError(
            f"Minimum edge length in edge mesh {lengths.min()} is too small "
            f"in comparison to minimum edge length in polyMesh "
            f"{mesh_min_edge}")
    used = np.unique(edges)
    mins = points[used].min(axis=0)
    maxs = points[used].max(axis=0)
    # the reference's perimeter formula including its z-term quirk
    # (max+min, bPS.C:71 / smoothMesh.C:1538)
    em_perim = (maxs[0] - mins[0]) + (maxs[1] - mins[1]) + (maxs[2] + mins[2])
    if abs(em_perim / mesh_perimeter - 1.0) > 0.5:
        raise ValueError(
            f"Perimeter (sum of bounding box side lengths) of edge mesh "
            f"{em_perim} is too different in comparison to perimeter of "
            f"polyMesh {mesh_perimeter}")


def point_edge_valence(n_points: int, edges: np.ndarray) -> np.ndarray:
    v = np.zeros(n_points, dtype=np.int64)
    np.add.at(v, edges.reshape(-1), 1)
    return v


def find_edge_strings(points: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Label continuous edge strings (paths joined at valence-2
    vertices, broken at corners) — reference findEdgeMeshStrings
    (bPS.C:446-587), iterative flood fill."""
    valence = point_edge_valence(len(points), edges)
    incid = {}
    for e, (a, b) in enumerate(edges):
        incid.setdefault(a, []).append(e)
        incid.setdefault(b, []).append(e)

    strings = np.full(len(edges), UNDEF, dtype=np.int64)
    next_id = 0
    for e0 in range(len(edges)):
        if strings[e0] >= 0:
            continue
        sid = next_id
        next_id += 1
        stack = [e0]
        strings[e0] = sid
        while stack:
            e = stack.pop()
            for endpoint in edges[e]:
                if valence[endpoint] != 2:
                    continue  # corners break strings
                for e2 in incid[endpoint]:
                    if strings[e2] < 0:
                        strings[e2] = sid
                        stack.append(e2)
    return strings


def project_point_to_edges(pt: np.ndarray, points: np.ndarray,
                           edges: np.ndarray, tol: float):
    """Project pt onto every edge (clipped at endpoints), return
    (proj (E,3), dist (E,), coincident vertex id (E,) or -1) —
    vectorized reference projectPointToEdge (bPS.C:89-145)."""
    a = points[edges[:, 0]]
    b = points[edges[:, 1]]
    ab = b - a
    ll = np.sum(ab * ab, axis=1)
    ndp = np.sum((pt - a) * ab, axis=1) / np.maximum(ll, 1e-300)
    free = a + ndp[:, None] * ab
    proj = np.where((ndp <= ABS_TOL)[:, None], a,
                    np.where((ndp >= 1 - ABS_TOL)[:, None], b, free))
    vert = np.full(len(edges), UNDEF, dtype=np.int64)
    near_a = (ndp <= ABS_TOL) & (
        np.linalg.norm(free - a, axis=1) <= tol)
    near_b = (ndp >= 1 - ABS_TOL) & (
        np.linalg.norm(free - b, axis=1) <= tol)
    vert[near_a] = edges[near_a, 0]
    vert[near_b] = edges[near_b, 1]
    dist = np.linalg.norm(proj - pt, axis=1)
    return proj, dist, vert


def find_closest_edge_info(pt, points, edges, strings, required_string,
                           tol):
    """reference findClosestEdgeInfo (bPS.C:206-264)."""
    proj, dist, vert = project_point_to_edges(pt, points, edges, tol)
    if required_string >= 0:
        dist = np.where(strings == required_string, dist, np.inf)
    i = int(np.argmin(dist))
    sid = strings[i] if len(strings) == len(edges) else UNDEF
    return proj[i], i, sid, vert[i]


def closest_edge_batch(pts: np.ndarray, epoints: np.ndarray,
                       edges: np.ndarray, tol: float,
                       pair_budget: int = 4_000_000):
    """:func:`find_closest_edge_info` over a batch of query points (no
    string filter) -> (proj (B,3), edge idx (B,), coincident vertex
    (B,)), in chunks so the (Q, E, 3) intermediates stay within a fixed
    memory budget."""
    B, E = len(pts), len(edges)
    proj_o = np.zeros((B, 3))
    ei_o = np.zeros(B, dtype=np.int64)
    vert_o = np.full(B, UNDEF, dtype=np.int64)
    if B == 0 or E == 0:
        return proj_o, ei_o, vert_o
    a = epoints[edges[:, 0]]
    b = epoints[edges[:, 1]]
    ab = b - a
    ll = np.maximum(np.sum(ab * ab, axis=1), 1e-300)
    chunk = max(1, pair_budget // E)
    for s in range(0, B, chunk):
        q = pts[s: s + chunk]                                # (Q, 3)
        ndp = ((q[:, None, :] - a) * ab).sum(-1) / ll        # (Q, E)
        free = a + ndp[..., None] * ab                       # (Q, E, 3)
        lo = ndp <= ABS_TOL
        hi = ndp >= 1 - ABS_TOL
        proj = np.where(lo[..., None], a,
                        np.where(hi[..., None], b, free))
        dist = np.linalg.norm(proj - q[:, None, :], axis=-1)
        i = np.argmin(dist, axis=1)                          # (Q,)
        r = np.arange(len(q))
        near_a = lo & (np.linalg.norm(free - a, axis=-1) <= tol)
        near_b = hi & (np.linalg.norm(free - b, axis=-1) <= tol)
        vert = np.where(near_a, edges[:, 0],
                        np.where(near_b, edges[:, 1], UNDEF))
        proj_o[s: s + chunk] = proj[r, i]
        ei_o[s: s + chunk] = i
        vert_o[s: s + chunk] = vert[r, i]
    return proj_o, ei_o, vert_o


# ---------------------------------------------------------------------------
# Host: classification
# ---------------------------------------------------------------------------

def classifying_patch(topo: MeshTopology) -> np.ndarray:
    """Per point: the patch id of its lowest-numbered real boundary
    face (-1 for pure internal / processor-only points) — reproduces
    the reference's first-visit patch assignment (bPS.C:301-318)."""
    out = np.full(topo.n_points, UNDEF, dtype=np.int64)
    real = np.array([t not in ("processor", "empty")
                     for t in topo.patch_types])
    # first visit (lowest face id) wins: scatter-min of face ids per
    # point, then read the winning face's patch
    fb = np.arange(topo.n_internal_faces, topo.n_faces)
    pid = topo.face_patch[fb]
    ok = (pid >= 0) & real[np.maximum(pid, 0)]
    fb = fb[ok]
    if len(fb):
        mask = topo.face_mask[fb]
        flat_p = topo.face_points[fb][mask]
        flat_f = np.repeat(fb, mask.sum(axis=1))
        first = np.full(topo.n_points, np.iinfo(np.int64).max)
        np.minimum.at(first, flat_p, flat_f)
        has = first < np.iinfo(np.int64).max
        out[has] = topo.face_patch[first[has]]
    return out


@dataclasses.dataclass
class BoundarySetup:
    is_corner: np.ndarray            # (N,)
    is_feature_edge: np.ndarray      # (N,)
    is_smoothing_surface: np.ndarray
    is_frozen_surface: np.ndarray
    is_layer_surface: np.ndarray
    is_connected: np.ndarray
    corner_targets: np.ndarray       # (N, 3)
    point_strings: np.ndarray        # (N,) target string per feature point
    # feature-point neighbour table (surface, non-feature, non-corner)
    feat_neigh: np.ndarray           # (N, W) point ids
    feat_neigh_mask: np.ndarray      # (N, W)
    # target geometry, in mesh coordinates
    target_edge_points: np.ndarray   # (Ve, 3)
    target_edges: np.ndarray         # (Ee, 2)
    target_edge_strings: np.ndarray  # (Ee,)
    surf_tri_a: np.ndarray           # (T, 3)
    surf_tri_b: np.ndarray
    surf_tri_c: np.ndarray
    distance_tolerance: float


def classify_boundary_points(
    topo: MeshTopology,
    init_edge_points: np.ndarray, init_edges: np.ndarray,
    target_edge_points: np.ndarray, target_edges: np.ndarray,
    surf_vertices: np.ndarray, surf_tris: np.ndarray,
    layer_patch_ids, smoothing_patch_ids,
    mesh_points: np.ndarray,
    distance_tolerance: float,
    checkpoint_corner: Optional[np.ndarray] = None,
    checkpoint_feature: Optional[np.ndarray] = None,
) -> BoundarySetup:
    """reference classifyBoundaryPoints (bPS.C:269-441) + string
    assignment (src/smoothMesh.C:2234-2249)."""
    N = topo.n_points
    internal = topo.is_internal_point
    cp = classifying_patch(topo)

    is_corner = np.zeros(N, dtype=bool)
    is_feature = np.zeros(N, dtype=bool)
    corner_targets = np.full((N, 3), 1e30)

    target_strings = find_edge_strings(target_edge_points, target_edges)
    init_valence = point_edge_valence(len(init_edge_points), init_edges)
    target_valence = point_edge_valence(len(target_edge_points),
                                        target_edges)
    target_corner_ids = np.where(target_valence != 2)[0]

    bnd = np.where(~internal & (cp >= 0))[0]

    use_ckpt = (
        checkpoint_corner is not None and checkpoint_feature is not None
        and (checkpoint_corner == 1).any() | (checkpoint_feature == 1).any()
    )

    if use_ckpt:
        is_corner[bnd] = np.asarray(checkpoint_corner)[bnd] == 1
        is_feature[bnd] = np.asarray(checkpoint_feature)[bnd] == 1
    elif len(bnd):
        # batched closest-edge query (bPS.C:206-264 semantics)
        projp, _, vert = closest_edge_batch(
            mesh_points[bnd], init_edge_points, init_edges,
            distance_tolerance)
        at_corner_vert = (vert >= 0) & (
            init_valence[np.maximum(vert, 0)] != 2)
        on_edge = np.linalg.norm(mesh_points[bnd] - projp,
                                 axis=1) < distance_tolerance
        is_corner[bnd] = at_corner_vert
        is_feature[bnd] = ~at_corner_vert & on_edge

    corner_ids = np.where(is_corner)[0]
    if len(corner_ids):
        if len(target_corner_ids) == 0:
            raise ValueError(
                "Did not find any eligible corner points in edge mesh")
        # snap target: closest corner vertex of the target edge mesh
        d = np.linalg.norm(
            mesh_points[corner_ids][:, None, :]
            - target_edge_points[target_corner_ids][None, :, :], axis=2)
        corner_targets[corner_ids] = target_edge_points[
            target_corner_ids[np.argmin(d, axis=1)]]

    is_layer = (cp >= 0) & np.isin(cp, np.asarray(layer_patch_ids)) & ~internal
    on_smooth_patch = (cp >= 0) & np.isin(
        cp, np.asarray(smoothing_patch_ids)) & ~internal
    is_frozen_surface = ~internal & (cp >= 0) & ~on_smooth_patch

    nb_internal = internal[topo.point_points] & topo.point_points_mask
    is_connected = ~internal & nb_internal.any(axis=1)

    # per-feature-point string ids against the *target* edges
    point_strings = np.full(N, UNDEF, dtype=np.int64)
    feat_ids = np.where(is_feature)[0]
    if len(feat_ids):
        _, ei, _ = closest_edge_batch(
            mesh_points[feat_ids], target_edge_points, target_edges,
            distance_tolerance)
        point_strings[feat_ids] = target_strings[ei]

    # feature-point neighbour table (findNeighborSurfacePoints,
    # bPS.C:592-616): boundary neighbours that are neither feature nor
    # corner points
    ok_neigh = (~internal[topo.point_points] & ~is_feature[topo.point_points]
                & ~is_corner[topo.point_points] & topo.point_points_mask)
    ok_neigh &= is_feature[:, None]
    feat_neigh = np.where(ok_neigh, topo.point_points, 0)

    tri = surf_tris
    return BoundarySetup(
        is_corner=is_corner,
        is_feature_edge=is_feature,
        is_smoothing_surface=on_smooth_patch,
        is_frozen_surface=is_frozen_surface,
        is_layer_surface=is_layer,
        is_connected=is_connected,
        corner_targets=corner_targets,
        point_strings=point_strings,
        feat_neigh=feat_neigh,
        feat_neigh_mask=ok_neigh,
        target_edge_points=target_edge_points,
        target_edges=target_edges,
        target_edge_strings=target_strings,
        surf_tri_a=surf_vertices[tri[:, 0]],
        surf_tri_b=surf_vertices[tri[:, 1]],
        surf_tri_c=surf_vertices[tri[:, 2]],
        distance_tolerance=distance_tolerance,
    )


# ---------------------------------------------------------------------------
# Per iteration (plain PyTorch, plus K8)
# ---------------------------------------------------------------------------

def _project_to_edges_dev(pts, ea, eb):
    """Clipped projection of pts (B, 3) onto every edge (E,) ->
    (proj (B, E, 3), dist (B, E)): projectPointToEdge on the device."""
    ab = eb - ea                                        # (E, 3)
    ll = dot3(ab, ab)
    ndp = ((dot3(pts[:, None, :], ab[None]) - dot3(ea, ab)[None, :])
           / ll.clamp_min(1e-30)[None, :])              # (B, E)
    ndp_c = ndp.clamp(0.0, 1.0)
    ndp_c = torch.where(ndp <= ABS_TOL, 0.0, ndp_c)
    ndp_c = torch.where(ndp >= 1 - ABS_TOL, 1.0, ndp_c)
    proj = ea[None] + ndp_c[..., None] * ab[None]       # (B, E, 3)
    return proj, norm3(proj - pts[:, None, :])


def feature_edge_projections(points, bd):
    """Sum and count of the string-filtered projections of each feature
    point's surface neighbours onto the target edges (reference
    calculateFeatureEdgeProjections bPS.C:623-677) -> (sums (N, 3),
    counts (N,)); the caller divides (reference :898).

    Only the rows ``bd["feat_rows"]`` (the feature points with
    neighbours, a few hundred of N) are evaluated and scattered back.
    """
    N = points.shape[0]
    rows = bd["feat_rows"]
    fn = bd["feat_neigh"][rows]                          # (K, W)
    fm = bd["feat_neigh_mask"][rows]
    K, W = fn.shape
    estr = bd["edge_strings"]                            # (E,)

    proj, dist = _project_to_edges_dev(points[fn.reshape(-1).long()],
                                       bd["edge_a"], bd["edge_b"])
    pstr = bd["point_strings"][rows].repeat_interleave(W)
    allowed = (pstr[:, None] < 0) | (estr[None, :] == pstr[:, None])
    dist = torch.where(allowed, dist, torch.inf)
    best = torch.argmin(dist, dim=1)
    bestp = proj[torch.arange(K * W, device=points.device), best]
    bestp = bestp.reshape(K, W, 3)
    sums = torch.zeros((N, 3), dtype=points.dtype, device=points.device)
    counts = torch.zeros((N,), dtype=torch.int64, device=points.device)
    sums[rows] = (bestp * fm[..., None].to(points.dtype)).sum(1)
    counts[rows] = fm.sum(1)
    return sums, counts


def surface_centroids(face_centres, td, rows):
    """Mean of the adjacent real-boundary face centres of the points
    ``rows`` (reference calculateSurfaceCentroids bPS.C:781-839), from
    this iteration's (F, 3) face centres (K1's output)."""
    pf = td["point_faces"][rows].long()
    sel = td["point_faces_mask"][rows] & td["face_is_real_boundary"][pf]
    sums = (face_centres[pf] * sel[..., None].to(face_centres.dtype)).sum(1)
    return sums / sel.sum(1).clamp_min(1)[:, None]


def project_boundary_points(points, proposal, normals, frozen, bd, td,
                            is_sharp, face_centres,
                            ray_cast=raycast.segment_triangle_hits):
    """Priority projection of boundary points (reference
    projectBoundaryPointsToEdgesAndSurfaces bPS.C:843-945):

      corner -> stored corner target
      feature edge -> mean of neighbour projections
      sharp edge -> freeze
      free smoothing-surface -> ray-cast snap along +-normal

    -> (new proposal, frozen, no_hit): ``no_hit`` marks free
    smoothing-surface points whose ray cast found no intersection (the
    driver raises on them under ``ray_miss_fatal``, else they stay
    frozen).  One search at the reference's final radius (bPS.C:909-940)
    finds the same nearest hit as its four growing radii.

    ``face_centres``: this iteration's (F, 3) face centres, for the
    face-centroid blend of the rows ``bd["smooth_rows"]``.
    ``ray_cast``: the ray cast (:func:`raycast.segment_triangle_hits`,
    K8 on CUDA tensors, or its plain version); it runs on the rows
    ``bd["surf_rows"]``, the statically classified superset of the free
    points.
    """
    sums, counts = feature_edge_projections(points, bd)

    is_corner = bd["is_corner"]
    is_feature = bd["is_feature_edge"]
    is_smoothing = bd["is_smoothing_surface"]
    internal = td["is_internal_point"]

    out = torch.where((is_corner & ~internal)[:, None], bd["corner_targets"],
                      proposal)
    feat_mean = sums / counts.clamp_min(1)[:, None]
    out = torch.where((is_feature & ~internal & (counts > 0))[:, None],
                      feat_mean, out)
    sharp_freeze = ~internal & is_sharp & ~is_corner & ~is_feature
    frozen = frozen | sharp_freeze

    free = (~internal & is_smoothing & ~is_corner & ~is_feature
            & ~sharp_freeze)
    max_dist = bd["distance_tolerance"] * (1.0 / REL_TOL) ** 4

    # the face-centroid blend of the smoothing-surface points
    # (bPS.C:869-885), at the reference's fixed fraction
    srows = bd["smooth_rows"]
    w = FACE_CENTROID_BLENDING_FRACTION
    out[srows] = (w * surface_centroids(face_centres, td, srows)
                  + (1.0 - w) * out[srows])

    rows = bd["surf_rows"]
    o = out[rows]
    d = normals[rows]
    tp, tn = ray_cast(o, d, max_dist, bd["tri_packed"])
    # the closest of the two directional hits; on an exact tie the
    # reference searches the whole segment from the +normal end
    # (findIntersection bPS.C:720-741) and so takes the + side
    hit_c = torch.where((tp <= tn)[:, None], o + tp[:, None] * d,
                        o - tn[:, None] * d)
    hit = torch.zeros_like(out)
    has = torch.zeros_like(free)
    hit[rows] = hit_c
    has[rows] = torch.isfinite(torch.minimum(tp, tn))
    out = torch.where((free & has)[:, None], hit, out)
    no_hit = free & ~has
    return out, frozen | no_hit, no_hit
