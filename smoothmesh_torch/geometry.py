"""Mesh geometry, recomputed each iteration from the points.

OpenFOAM's ``primitiveMesh`` face/cell geometry (reference
src/smoothMesh.C:129, :1218 via ``mesh.C()``), which
``mesh.movePoints`` keeps up to date each iteration (:2399):

  - face centre/area: fan decomposition of the polygon about the vertex
    average; area-weighted sub-triangle centroid average.
  - cell centre/volume: face-pyramid decomposition about the average of
    face centres; pyramid-volume-weighted centroid average.

Each function has a plain PyTorch version (``*_plain``, masked gathers
over the padded topology, any float dtype) and a wrapper of the same
name without the suffix: for CPU tensors the wrapper runs the plain
version, for CUDA tensors it launches the hand-written kernel
(``csrc/face_geometry.cu`` = K1, ``csrc/cell_centres.cu`` = K2; float32)
or raises.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from smoothmesh_torch import kernels

ROOT_VSMALL = 1e-18
VSMALL = 1e-30


class FaceGeometry(NamedTuple):
    centres: torch.Tensor   # (F, 3)
    areas: torch.Tensor     # (F, 3) area vectors (owner-outward normal)
    means: torch.Tensor     # (F, 3) vertex means


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the last axis (of 3), summed in the kernels'
    order: (x + y) + z."""
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return ax * bx + ay * by + az * bz


def norm3(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm over the last axis, sqrt of the summed squares."""
    n = torch.sqrt(dot3(v, v))
    return n.unsqueeze(-1) if keepdim else n


def face_centres_areas_plain(points, face_points, face_mask,
                             face_npoints) -> FaceGeometry:
    dtype = points.dtype
    p = points[face_points.long()]                     # (F, W, 3)
    W = face_points.shape[1]
    slot = torch.arange(W, device=points.device)[None, :]
    is_last = slot == (face_npoints.long()[:, None] - 1)
    rolled = torch.roll(p, -1, dims=1)
    nxt = torch.where(is_last[..., None], p[:, :1, :], rolled)
    m = face_mask[..., None].to(dtype)
    n_pts = face_npoints.to(dtype)[:, None]

    means = (p * m).sum(1) / n_pts                     # vertex average

    fc = means[:, None, :]
    c = p + nxt + fc                                   # (F, W, 3)
    n_vec = torch.linalg.cross(nxt - p, fc - p, dim=-1)
    a = norm3(n_vec, keepdim=True)                     # (F, W, 1)

    sum_n = (n_vec * m).sum(1)
    sum_a = (a * m).sum(1)                             # (F, 1)
    sum_ac = (a * c * m).sum(1)

    good = sum_a[:, 0] > ROOT_VSMALL
    centres = torch.where(
        good[:, None], sum_ac / (3.0 * sum_a.clamp_min(VSMALL)), means)
    areas = torch.where(good[:, None], 0.5 * sum_n, torch.zeros_like(sum_n))
    return FaceGeometry(centres, areas, means)


def face_centres_areas(points, face_points, face_mask,
                       face_npoints) -> FaceGeometry:
    """OpenFOAM face centres, area vectors and vertex means (K1)."""
    dev = points.device
    if dev.type == "cpu":
        return face_centres_areas_plain(points, face_points, face_mask,
                                        face_npoints)
    if dev.type != "cuda":
        raise ValueError(f"face_centres_areas: no kernel for {dev}")
    n_faces, width = face_points.shape
    kernels.check(points, "points", torch.float32, (points.shape[0], 3), dev)
    kernels.check(face_points, "face_points", torch.int32,
                  (n_faces, width), dev)
    kernels.check(face_npoints, "face_npoints", torch.int32, (n_faces,), dev)
    out = [torch.empty((n_faces, 3), dtype=torch.float32, device=dev)
           for _ in range(3)]
    kernels.FACE_GEOMETRY.launch(
        points.data_ptr(), face_points.data_ptr(), face_npoints.data_ptr(),
        n_faces, width, *(t.data_ptr() for t in out))
    return FaceGeometry(*out)


def cell_centres_vols_plain(face_geo: FaceGeometry, owner, cell_faces,
                            cell_faces_mask) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    cf = cell_faces.long()
    f_ctrs = face_geo.centres[cf]                # (C, W, 3)
    f_areas = face_geo.areas[cf]                 # (C, W, 3)
    dtype = f_ctrs.dtype
    mask = cell_faces_mask.to(dtype)
    m = mask[..., None]
    n_faces = mask.sum(1)[:, None]

    c_est = (f_ctrs * m).sum(1) / n_faces.clamp_min(1.0)

    # Sign: +1 when this cell owns the face (outward area), else -1
    cell_ids = torch.arange(cf.shape[0], device=cf.device)[:, None]
    sign = torch.where(owner.long()[cf] == cell_ids, 1.0, -1.0).to(dtype)

    d = f_ctrs - c_est[:, None, :]
    pyr3vol = sign * dot3(f_areas, d)                       # (C, W)
    pc = 0.75 * f_ctrs + 0.25 * c_est[:, None, :]

    vol3 = (pyr3vol * mask).sum(1)                          # (C,)
    ctr_num = ((pyr3vol * mask)[..., None] * pc).sum(1)
    good = vol3.abs() > VSMALL
    centres = torch.where(
        good[:, None], ctr_num / torch.where(good, vol3, 1.0)[:, None],
        c_est)
    vols = vol3 / 3.0
    return centres, vols


def cell_centres_vols(face_geo: FaceGeometry, owner, cell_faces,
                      cell_faces_mask) -> Tuple[torch.Tensor, torch.Tensor]:
    """OpenFOAM cell centres and volumes (K2)."""
    dev = face_geo.centres.device
    if dev.type == "cpu":
        return cell_centres_vols_plain(face_geo, owner, cell_faces,
                                       cell_faces_mask)
    if dev.type != "cuda":
        raise ValueError(f"cell_centres_vols: no kernel for {dev}")
    n_cells, width = cell_faces.shape
    n_faces = owner.shape[0]
    kernels.check(face_geo.centres, "face centres", torch.float32,
                  (n_faces, 3), dev)
    kernels.check(face_geo.areas, "face areas", torch.float32,
                  (n_faces, 3), dev)
    kernels.check(owner, "owner", torch.int32, (n_faces,), dev)
    kernels.check(cell_faces, "cell_faces", torch.int32, (n_cells, width),
                  dev)
    kernels.check(cell_faces_mask, "cell_faces_mask", torch.bool,
                  (n_cells, width), dev)
    centres = torch.empty((n_cells, 3), dtype=torch.float32, device=dev)
    vols = torch.empty((n_cells,), dtype=torch.float32, device=dev)
    kernels.CELL_CENTRES.launch(
        face_geo.centres.data_ptr(), face_geo.areas.data_ptr(),
        owner.data_ptr(), cell_faces.data_ptr(), cell_faces_mask.data_ptr(),
        n_cells, width, centres.data_ptr(), vols.data_ptr())
    return centres, vols


def cell_centres(points, td) -> torch.Tensor:
    """Convenience: cell centres from points + device topology dict."""
    fg = face_centres_areas(points, td["face_points"], td["face_mask"],
                            td["face_npoints"])
    ctrs, _ = cell_centres_vols(fg, td["owner"], td["cell_faces"],
                                td["cell_faces_mask"])
    return ctrs


def boundary_point_normals(points, td):
    """Inward area-normalized point normals on real boundary patches
    -> (normals (N, 3), is_sharp (N,)).

    Reimplements ``calculateBoundaryPointNormals`` (reference
    src/orthogonalBoundaryBlending.C:141-233): sum of inverted unit face
    normals of adjacent non-processor / non-empty patch faces; points
    whose summed normal has magnitude < 0.1 are "sharp edge points" and
    get a zero normal; otherwise the normal is normalized.  This is the
    per-iteration update ``layers.accumulate_point_normals`` from a zero
    field.
    """
    # layers imports this module
    from smoothmesh_torch.layers import accumulate_point_normals

    fg = face_centres_areas(points, td["face_points"], td["face_mask"],
                            td["face_npoints"])
    return accumulate_point_normals(torch.zeros_like(points), fg.areas, td)
