"""Orthogonal boundary-layer blending (reference
src/orthogonalBoundaryBlending.C).

Host set-up (numpy, once; a copy of ``smoothmesh_tpu.layers``):

  - hop counts to layer/smoothing boundaries
    (``calculatePointHopsToBoundary`` oBB.C:52-134, with the
    reference's quirk: an internal point's hop count is
    max(neighbour hops)+1, giving layer *indices* along prismatic
    stacks, not geodesic distance)
  - prismatic outer/inner neighbour maps (``propagateOuterNeighInfo``
    oBB.C:244-391, ``propagateInnerNeighInfo`` :396-459), including
    multiply-connected invalidation and normal propagation along unique
    prismatic edges

Per iteration (plain PyTorch, as the JAX package's are plain XLA; on
the card the normals run as the CUDA kernel K9, ``csrc/point_normals.cu``):

  - stateful boundary point normals (``calculateBoundaryPointNormals``
    oBB.C:141-233: the reference accumulates into the previous,
    already-normalized field each iteration)
  - neighbour coordinate gather (``updateNeighCoords`` :464-501)
  - orthogonal blending (``blendWithOrthogonalPoints`` :507-567)
  - prismatic projection of boundary points
    (``projectPrismaticInternalPointsToSurfaces`` :573-633)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from smoothmesh_torch import kernels
from smoothmesh_torch.boundary import classifying_patch
from smoothmesh_torch.geometry import dot3, norm3, slot_sum
from smoothmesh_torch.mesh.topology import MeshTopology

UNDEF = -1
#: the undefined neighbour coordinate (OpenFOAM's GREAT, float32-safe);
#: the consumers skip rows with a component beyond 1e17
BIG = 1e18


def patch_point_mask(topo: MeshTopology, patch_ids) -> np.ndarray:
    """Points on any face of the given patches (reference
    getPatchPointIndices, oBB.C:22-46)."""
    mask = np.zeros(topo.n_points, dtype=bool)
    sel = np.isin(topo.face_patch, np.asarray(patch_ids, dtype=np.int64))
    pts = topo.face_points[sel][topo.face_mask[sel]]
    mask[pts] = True
    return mask


def connected_to_internal(topo: MeshTopology) -> np.ndarray:
    """Boundary points with at least one internal neighbour (reference
    classifyBoundaryPoints, bPS.C:332-340)."""
    internal = topo.is_internal_point
    nb_internal = internal[topo.point_points] & topo.point_points_mask
    return ~internal & nb_internal.any(axis=1)


def point_hops_to_boundary(topo: MeshTopology, patch_ids,
                           is_connected: np.ndarray,
                           max_iter: int) -> np.ndarray:
    """Reference calculatePointHopsToBoundary (oBB.C:52-134), global."""
    hops = np.full(topo.n_points, UNDEF, dtype=np.int64)
    seed = patch_point_mask(topo, patch_ids) & is_connected
    hops[seed] = 0
    internal = topo.is_internal_point
    pp = topo.point_points
    ppm = topo.point_points_mask
    new_hops = np.full(topo.n_points, -1, dtype=np.int64)
    for _ in range(max_iter):
        nb = np.where(ppm, hops[pp], -1)
        max_nb = nb.max(axis=1)
        cand = (hops < 0) & internal & (max_nb >= 0)
        new_hops[cand] = max_nb[cand] + 1
        grow = new_hops > hops
        hops[grow] = new_hops[grow]
    return hops


def boundary_point_normals_np(points: np.ndarray, topo: MeshTopology):
    """Host (numpy) boundary point normals -> (normals (N, 3), is_sharp
    (N,)), for the global set-up of the halo driver, which holds no
    global topology on the device (the JAX package's
    ``layers.boundary_point_normals_np``, same arithmetic)."""
    fp = topo.face_points
    fm = topo.face_mask
    fn = np.maximum(topo.face_npoints.astype(np.float64), 1.0)
    p = points[fp]
    f_centre = (p * fm[..., None]).sum(axis=1) / fn[:, None]
    nxt = points[topo.face_points_next]
    nv = np.cross(nxt - p, f_centre[:, None, :] - p)
    a = np.linalg.norm(nv, axis=-1, keepdims=True)
    sum_n = (nv * fm[..., None]).sum(axis=1)
    sum_a = (a * fm[..., None]).sum(axis=1)
    areas = np.where(sum_a > 1e-18, 0.5 * sum_n, 0.0)
    mags = np.linalg.norm(areas, axis=-1)
    unit = areas / np.maximum(mags, 1e-300)[:, None]

    real_patch = np.array([t not in ("processor", "empty")
                           for t in topo.patch_types])
    eligible = np.zeros(topo.n_faces, dtype=bool)
    bnd = topo.face_patch >= 0
    eligible[bnd] = real_patch[topo.face_patch[bnd]]

    pf = topo.point_faces
    sel = topo.point_faces_mask & eligible[pf]
    normals = -(unit[pf] * sel[..., None]).sum(axis=1)
    n_faces = sel.sum(axis=1)
    mag = np.linalg.norm(normals, axis=-1)
    is_sharp = (n_faces >= 1) & (mag < 0.1)
    normals[is_sharp] = 0.0
    nz = (mag > 0) & ~is_sharp
    normals[nz] /= mag[nz][:, None]
    return normals, is_sharp


@dataclasses.dataclass
class LayerMaps:
    hops_layer: np.ndarray          # (N,)
    hops_smoothing: np.ndarray      # (N,)
    outer_map: np.ndarray           # (N,) point -> outer (boundary-ward)
    inner_map: np.ndarray           # (N,) boundary point -> first inner
    normals_init: np.ndarray        # (N, 3) incl. propagated internal
    is_sharp_init: np.ndarray       # (N,)
    layer_surface: np.ndarray       # (N,) bool
    smoothing_surface: np.ndarray   # (N,) bool
    is_connected: np.ndarray        # (N,) bool


def _last_slot(nb: np.ndarray) -> np.ndarray:
    """Per row: the last True slot of ``nb`` (0 where none)."""
    return np.where(nb.any(axis=1),
                    nb.shape[1] - 1 - np.argmax(nb[:, ::-1], axis=1), 0)


def build_layer_maps(topo: MeshTopology, boundary_normals: np.ndarray,
                     is_sharp: np.ndarray, layer_patch_ids,
                     smoothing_patch_ids, max_layers: int) -> LayerMaps:
    """One-time set-up equivalent of reference src/smoothMesh.C:2215-2230."""
    is_conn = connected_to_internal(topo)
    hops_layer = point_hops_to_boundary(topo, layer_patch_ids, is_conn,
                                        max_layers + 1)
    hops_smooth = point_hops_to_boundary(topo, smoothing_patch_ids, is_conn,
                                         2)
    # Surface-point flags use the reference's first-patch-wins
    # classification (bPS.C:301-318); the hop seeds above use the plain
    # any-face patch membership (getPatchPointIndices), matching the two
    # different reference code paths.
    cpatch = classifying_patch(topo)
    internal = topo.is_internal_point
    layer_surface = (~internal & (cpatch >= 0)
                     & np.isin(cpatch, np.asarray(layer_patch_ids)))
    smoothing_surface = (~internal & (cpatch >= 0)
                         & np.isin(cpatch, np.asarray(smoothing_patch_ids)))

    normals = boundary_normals.astype(np.float64).copy()
    pp = topo.point_points
    ppm = topo.point_points_mask
    rows = np.arange(topo.n_points)

    outer_map = np.full(topo.n_points, UNDEF, dtype=np.int64)
    invalid = np.zeros(topo.n_points, dtype=bool)

    # propagateOuterNeighInfo (oBB.C:244-391): level by level towards
    # the interior; a point maps outward iff exactly one neighbour has
    # hop-1; a boundary target must be on a layer patch; a target
    # claimed twice invalidates all claimants (and the invalidation
    # propagates to higher levels through the copied normals).
    for lvl in range(1, max_layers + 2):
        at_lvl = hops_layer == lvl
        nb_low = ppm & (hops_layer[pp] == lvl - 1)
        n_low = nb_low.sum(axis=1)
        # the reference keeps the *last* matching neighbour; unique anyway
        neigh = pp[rows, _last_slot(nb_low)]
        cand = at_lvl & (n_low == 1)
        cand &= internal[neigh] | layer_surface[neigh]
        claims = np.zeros(topo.n_points, dtype=np.int64)
        np.add.at(claims, neigh[cand], 1)
        conflict = cand & (claims[neigh] >= 2)
        good = cand & ~conflict
        outer_map[good] = neigh[good]
        normals[good] = normals[neigh[good]]
        invalid[good] |= invalid[neigh[good]]   # propagate invalidation
        invalid[conflict] = True

    normals[invalid] = 0.0
    outer_map[invalid] = UNDEF

    # propagateInnerNeighInfo (oBB.C:396-459)
    inner_map = np.full(topo.n_points, UNDEF, dtype=np.int64)
    nb_hi = ppm & (hops_smooth[pp] == 1)
    neigh_hi = pp[rows, _last_slot(nb_hi)]
    ok = (smoothing_surface & is_conn & (hops_smooth == 0)
          & (nb_hi.sum(axis=1) == 1))
    inner_map[ok] = neigh_hi[ok]

    return LayerMaps(
        hops_layer=hops_layer,
        hops_smoothing=hops_smooth,
        outer_map=outer_map,
        inner_map=inner_map,
        normals_init=normals,
        is_sharp_init=np.asarray(is_sharp, dtype=bool),
        layer_surface=layer_surface,
        smoothing_surface=smoothing_surface,
        is_connected=is_conn,
    )


# ---------------------------------------------------------------------------
# Per iteration (plain PyTorch)
# ---------------------------------------------------------------------------

def accumulate_point_normals(prev_normals, face_areas, td, sync=None):
    """Stateful normal update -> (normals (N, 3), is_sharp (N,)): add the
    inward unit normals of adjacent real-boundary faces to the previous
    (normalized) field, re-classify sharp points, renormalize (reference
    oBB.C:141-233, called each iteration at src/smoothMesh.C:2266
    *without* resetting the field).  Internal points keep their
    propagated normals.

    ``face_areas``: the (F, 3) face area vectors of this iteration (K1's
    output, so there is no second face pass).  ``sync``: the halo
    exchange (``parallel.sync``) or None; the summed face normals and
    counts of a shared point are then its owner's.

    K9 on float32 CUDA tensors without ``sync`` (bit-equal to
    :func:`accumulate_point_normals_plain`); the plain version on the
    CPU, in float64 and with ``sync``, whose exchange comes between the
    sums and the normalization.
    """
    dev = prev_normals.device
    if sync is not None or not kernels.takes_kernel(
            dev, prev_normals.dtype, "accumulate_point_normals"):
        return accumulate_point_normals_plain(prev_normals, face_areas, td,
                                              sync)
    n, n_faces = prev_normals.shape[0], face_areas.shape[0]
    pf, pfm = td["point_faces"], td["point_faces_mask"]
    real, internal = td["face_is_real_boundary"], td["is_internal_point"]
    wf = pf.shape[1]
    kernels.check(prev_normals, "prev_normals", torch.float32, (n, 3), dev)
    kernels.check(face_areas, "face_areas", torch.float32, (n_faces, 3),
                  dev)
    kernels.check(pf, "point_faces", torch.int32, (n, wf), dev)
    kernels.check(pfm, "point_faces_mask", torch.bool, (n, wf), dev)
    kernels.check(real, "face_is_real_boundary", torch.bool, (n_faces,),
                  dev)
    kernels.check(internal, "is_internal_point", torch.bool, (n,), dev)
    normals = torch.empty((n, 3), dtype=torch.float32, device=dev)
    is_sharp = torch.empty((n,), dtype=torch.bool, device=dev)
    kernels.POINT_NORMALS.launch(
        prev_normals.data_ptr(), face_areas.data_ptr(), pf.data_ptr(),
        pfm.data_ptr(), real.data_ptr(), internal.data_ptr(), n, wf,
        normals.data_ptr(), is_sharp.data_ptr(), device=normals.device)
    return normals, is_sharp


def accumulate_point_normals_plain(prev_normals, face_areas, td,
                                   sync=None):
    """:func:`accumulate_point_normals` in plain PyTorch, the faces of a
    point summed in slot order from +0 (K9's order; an unselected slot
    adds +0)."""
    dtype = prev_normals.dtype
    unit = face_areas / norm3(face_areas).clamp_min(1e-30)[:, None]
    pf = td["point_faces"].long()
    sel = td["point_faces_mask"] & td["face_is_real_boundary"][pf]
    add = -slot_sum(torch.where(sel[..., None], unit[pf], 0.0))
    n_faces = sel.sum(1)
    if sync is not None:
        add = sync.sum(add)
        n_faces = sync.sum(n_faces)

    normals = prev_normals + add
    mag = norm3(normals)
    is_sharp = (n_faces >= 1) & (mag < 0.1)
    normals = torch.where(is_sharp[:, None], 0.0, normals)
    nz = mag >= 1e-300 if dtype == torch.float64 else mag > 0
    normals = torch.where((nz & ~is_sharp)[:, None],
                          normals / mag.clamp_min(1e-30)[:, None], normals)
    return normals, is_sharp


def update_neigh_coords(points, neigh_map, sync=None):
    """Coordinates of each point's mapped neighbour, ``BIG`` where the
    map is undefined (reference oBB.C:464-501); with the halo exchange
    ``sync``, a shared point takes its owner's (whose map target is
    local)."""
    coords = points[neigh_map.clamp_min(0)]
    coords = torch.where((neigh_map >= 0)[:, None], coords, BIG)
    return coords if sync is None else sync.min_mag_sqr(coords)


def blend_with_orthogonal_points(points, new_points, td, hops, normals,
                                 outer_coords, layer_max_blending_fraction,
                                 layer_edge_length, layer_expansion_ratio,
                                 min_layers, max_layers_plus1):
    """Reference blendWithOrthogonalPoints (oBB.C:507-567).

    ``max_layers_plus1`` carries the reference's call-site +1
    (src/smoothMesh.C:2300).
    """
    dtype = points.dtype
    ok = ((normals != 0.0).any(-1) & td["is_internal_point"] & (hops >= 1)
          & (outer_coords.abs() < 1e17).all(-1))

    max_hops = (hops - 1).clamp(max=max_layers_plus1)
    # the base filled on the device: no host copy (it is captured in
    # the batched steps' CUDA graph)
    length = layer_edge_length * torch.pow(
        torch.full((), layer_expansion_ratio, dtype=dtype,
                   device=points.device), max_hops.to(dtype))

    slope = -layer_max_blending_fraction / (max_layers_plus1 - min_layers)
    y0 = -slope * max_layers_plus1
    y = y0 + slope * hops.to(dtype)
    blend = y.clamp(0.0, layer_max_blending_fraction)

    ortho = outer_coords + length[:, None] * normals
    blended = blend[:, None] * ortho + (1.0 - blend[:, None]) * new_points
    return torch.where(ok[:, None], blended, new_points)


def project_prismatic_boundary_points(new_points, bd, normals, inner_coords,
                                      is_sharp, internal_blend_frac):
    """Reference projectPrismaticInternalPointsToSurfaces (oBB.C:573-633):
    remove the tangential offset of a free smoothing-surface point
    relative to its first inner-layer neighbour along the point normal.
    ``bd``: the boundary tables (``smoothing_surface``, ``is_connected``,
    ``inner_map``, ``is_feature_edge``, ``is_corner``)."""
    ok = (bd["smoothing_surface"] & bd["is_connected"]
          & (bd["inner_map"] >= 0)
          & ~bd["is_feature_edge"] & ~bd["is_corner"] & ~is_sharp
          & (normals != 0.0).any(-1)
          & (inner_coords.abs() < 1e17).all(-1))

    c = new_points
    neigh_vec = c - inner_coords
    dot = dot3(neigh_vec, normals)[:, None]
    proj = c - (neigh_vec - dot * normals)
    out = internal_blend_frac * proj + (1.0 - internal_blend_frac) * c
    return torch.where(ok[:, None], out, new_points)
