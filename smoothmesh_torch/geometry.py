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
name without the suffix: for float32 CUDA tensors it launches the
hand-written kernel (``csrc/face_geometry.cu`` = K1,
``csrc/cell_centres.cu`` = K2) or raises; for CPU tensors and float64
CUDA tensors it runs the plain version (``kernels.takes_kernel``).
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


def slot_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the slot axis (1) in slot order, starting from +0: the
    kernels' order, so a sum of none or of zeros is +0 as there."""
    acc = torch.zeros_like(x[:, 0])
    for w in range(x.shape[1]):
        acc = acc + x[:, w]
    return acc


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, each component a*b - c*d as
    two rounded products and a rounded difference (the kernels')."""
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], -1)


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

    means = slot_sum(p * m) / n_pts                    # vertex average

    fc = means[:, None, :]
    c = p + nxt + fc                                   # (F, W, 3)
    n_vec = cross3(nxt - p, fc - p)
    a = norm3(n_vec, keepdim=True)                     # (F, W, 1)

    sum_n = slot_sum(n_vec * m)
    sum_a = slot_sum(a * m)                            # (F, 1)
    sum_ac = slot_sum(a * c * m)

    good = sum_a[:, 0] > ROOT_VSMALL
    centres = torch.where(
        good[:, None], sum_ac / (3.0 * sum_a.clamp_min(VSMALL)), means)
    areas = torch.where(good[:, None], 0.5 * sum_n, torch.zeros_like(sum_n))
    return FaceGeometry(centres, areas, means)


def face_centres_areas(points, face_points, face_mask,
                       face_npoints) -> FaceGeometry:
    """OpenFOAM face centres, area vectors and vertex means (K1)."""
    dev = points.device
    if not kernels.takes_kernel(dev, points.dtype, "face_centres_areas"):
        return face_centres_areas_plain(points, face_points, face_mask,
                                        face_npoints)
    n_faces, width = face_points.shape
    kernels.check(points, "points", torch.float32, (points.shape[0], 3), dev)
    kernels.check(face_points, "face_points", torch.int32,
                  (n_faces, width), dev)
    kernels.check(face_npoints, "face_npoints", torch.int32, (n_faces,), dev)
    out = [torch.empty((n_faces, 3), dtype=torch.float32, device=dev)
           for _ in range(3)]
    kernels.FACE_GEOMETRY.launch(
        points.data_ptr(), face_points.data_ptr(), face_npoints.data_ptr(),
        n_faces, width, *(t.data_ptr() for t in out),
        device=out[0].device)
    return FaceGeometry(*out)


def cell_centres_vols_plain(face_geo: FaceGeometry, td) -> Tuple[
        torch.Tensor, torch.Tensor]:
    """K2's plain version, on the tables ``owner``, ``cell_faces`` and
    ``cell_faces_mask`` of the device topology ``td``."""
    cf = td["cell_faces"].long()
    f_ctrs = face_geo.centres[cf]                # (C, W, 3)
    f_areas = face_geo.areas[cf]                 # (C, W, 3)
    dtype = f_ctrs.dtype
    mask = td["cell_faces_mask"].to(dtype)
    m = mask[..., None]
    n_faces = mask.sum(1)[:, None]

    c_est = slot_sum(f_ctrs * m) / n_faces.clamp_min(1.0)

    # Sign: +1 when this cell owns the face (outward area), else -1
    cell_ids = torch.arange(cf.shape[0], device=cf.device)[:, None]
    sign = torch.where(td["owner"].long()[cf] == cell_ids, 1.0,
                       -1.0).to(dtype)

    d = f_ctrs - c_est[:, None, :]
    pyr3vol = sign * dot3(f_areas, d)                       # (C, W)
    pc = 0.75 * f_ctrs + 0.25 * c_est[:, None, :]

    vol3 = slot_sum(pyr3vol * mask)                         # (C,)
    ctr_num = slot_sum((pyr3vol * mask)[..., None] * pc)
    good = vol3.abs() > VSMALL
    centres = torch.where(
        good[:, None], ctr_num / torch.where(good, vol3, 1.0)[:, None],
        c_est)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not the IEEE quotient
    vols = vol3 / torch.full_like(vol3, 3.0)
    return centres, vols


def cell_centres_vols(face_geo: FaceGeometry, td) -> Tuple[torch.Tensor,
                                                           torch.Tensor]:
    """OpenFOAM cell centres and volumes (K2).  On the card the kernel
    reads the cell-face words ``td["cell_face_words"]``
    (:func:`smoothmesh_torch.device.pack_cell_faces`), not ``owner``,
    ``cell_faces`` and ``cell_faces_mask``."""
    dev = face_geo.centres.device
    if not kernels.takes_kernel(dev, face_geo.centres.dtype,
                                "cell_centres_vols"):
        return cell_centres_vols_plain(face_geo, td)
    words = td["cell_face_words"]
    n_cells, width = words.shape
    n_faces = face_geo.centres.shape[0]
    kernels.check(face_geo.centres, "face centres", torch.float32,
                  (n_faces, 3), dev)
    kernels.check(face_geo.areas, "face areas", torch.float32,
                  (n_faces, 3), dev)
    kernels.check(words, "cell_face_words", torch.int32, (n_cells, width),
                  dev)
    centres = torch.empty((n_cells, 3), dtype=torch.float32, device=dev)
    vols = torch.empty((n_cells,), dtype=torch.float32, device=dev)
    kernels.CELL_CENTRES.launch(
        face_geo.centres.data_ptr(), face_geo.areas.data_ptr(),
        words.data_ptr(), n_cells, width, centres.data_ptr(),
        vols.data_ptr(), device=centres.device)
    return centres, vols


def cell_centres(points, td) -> torch.Tensor:
    """Convenience: cell centres from points + device topology dict."""
    fg = face_centres_areas(points, td["face_points"], td["face_mask"],
                            td["face_npoints"])
    ctrs, _ = cell_centres_vols(fg, td)
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
