"""Mesh-quality metrics: the checkMesh-style report, and mesh stats.

The reference validates its results with OpenFOAM's external
``checkMesh`` (reference run_tests.sh:31,36); this module is the
in-framework equivalent: non-orthogonality, skewness, face-face angles,
edge lengths, cell volumes, closedness, aspect ratio and face pyramids
(the JAX package's ``quality`` module, same keys, thresholds and claim
semantics).  It also holds the reference's mesh stats (min/max edge
length + bounding-box perimeter, src/smoothMesh.C:1478-1541) behind the
derived parameter defaults, computed on the host with numpy.

The report runs in the points' dtype on their device.  On the card in
float32 the face and cell geometry run K1 and K2, and the per-cell rows
of face data (area vectors and magnitudes over ``cell_faces``) are
gathered through K7 (:func:`smoothmesh_torch.ops.gather.table_gather`);
in float64 their plain versions run there; the rest is plain PyTorch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch

from smoothmesh_torch import geometry as geo
from smoothmesh_torch import kernels
from smoothmesh_torch.ops.constraints import EVAL_CHUNK, face_angles_for_edges
from smoothmesh_torch.ops.gather import table_gather

VSMALL = 1e-30

#: the device-topology tables the report reads
QUALITY_TD_KEYS = frozenset({
    "face_points", "face_mask", "face_npoints", "owner", "neighbour",
    "has_neighbour", "cell_faces", "cell_faces_mask", "edges",
    "edge_faces", "edge_cells", "edge_cells_mask", "edge_cell_f0",
    "edge_cell_f1",
})
#: what the report reads on the card: K2 reads the cell-face words
#: (``device.pack_cell_faces``); the rest of the report reads owner,
#: cell_faces and cell_faces_mask as on the CPU
CUDA_QUALITY_TD_KEYS = QUALITY_TD_KEYS | {"cell_face_words"}


def quality_td_keys(device, dtype) -> frozenset:
    """The tables the report reads for points of ``dtype`` on
    ``device``: K2's words where its kernel launches (float32 on the
    card), else the plain versions' tables."""
    return (CUDA_QUALITY_TD_KEYS
            if kernels.takes_kernel(device, dtype, "quality_report")
            else QUALITY_TD_KEYS)


@dataclasses.dataclass
class MeshStats:
    min_edge_length: float
    max_edge_length: float
    perimeter: float   # sum of bounding-box side lengths (reference quirk:
                       # z-term is max+min, matching src/smoothMesh.C:1538)


def mesh_stats(points: np.ndarray, edges: np.ndarray) -> MeshStats:
    p = np.asarray(points)
    e = np.asarray(edges)
    lengths = np.linalg.norm(p[e[:, 1]] - p[e[:, 0]], axis=1)
    mins = p.min(axis=0)
    maxs = p.max(axis=0)
    perimeter = (maxs[0] - mins[0]) + (maxs[1] - mins[1]) + (maxs[2] + mins[2])
    return MeshStats(float(lengths.min()), float(lengths.max()),
                     float(perimeter))


def _edge_face_angle_extrema(points, cell_ctrs, td, fc_base, edge_claim):
    """(min, max) face-face angle in radians over the claimed edges,
    EVAL_CHUNK edges at a time."""
    lo, hi = [], []
    for s in range(0, td["edges"].shape[0], EVAL_CHUNK):
        rows = slice(s, s + EVAL_CHUNK)
        emin, emax = face_angles_for_edges(points, cell_ctrs, td, fc_base,
                                           False, rows)
        if edge_claim is not None:
            emin = torch.where(edge_claim[rows], emin, math.inf)
            emax = torch.where(edge_claim[rows], emax, -math.inf)
        lo.append(emin.min())
        hi.append(emax.max())
    return torch.stack(lo).min(), torch.stack(hi).max()


def quality_report_parts(points, td, face_claim=None, edge_claim=None,
                         cell_claim=None) -> Dict[str, float]:
    """Partial quality aggregates over a claimed entity subset.

    ``*_claim`` (bool tensors) restrict which faces/edges/cells this
    invocation is responsible for (None = all); one parts dict per
    subset folds into the report with :func:`combine_quality_parts`,
    and the single-device report is the ``claim=None`` fold of one
    part.
    """
    dtype = points.dtype
    dev = points.device
    inf = math.inf
    fg = geo.face_centres_areas(points, td["face_points"], td["face_mask"],
                                td["face_npoints"])
    mags = geo.norm3(fg.areas)
    cell_ctrs, vols = geo.cell_centres_vols(fg, td)

    # Non-orthogonality (internal faces): angle between face area vector
    # and owner->neighbour centre vector
    has_n = td["has_neighbour"]
    if face_claim is not None:
        has_n = has_n & face_claim
    own_c = cell_ctrs[td["owner"].long()]
    nei_c = cell_ctrs[td["neighbour"].long()]
    d = nei_c - own_c
    dn = geo.norm3(d)
    an = mags.clamp_min(VSMALL)
    cos_t = geo.dot3(fg.areas, d) / (an * dn.clamp_min(VSMALL))
    nonortho = torch.rad2deg(torch.arccos(cos_t.clamp(-1.0, 1.0)))
    nonortho = torch.where(has_n, nonortho, 0.0)
    n_int = has_n.sum()

    # Skewness (internal faces): offset of the face centre from the
    # owner->neighbour line's intersection with the face plane, relative
    # to the centre distance
    nrm = fg.areas / an[:, None]
    denom = geo.dot3(d, nrm)
    ok = denom.abs() > VSMALL
    lam = geo.dot3(fg.centres - own_c, nrm) / torch.where(ok, denom, 1.0)
    intersect = own_c + lam[:, None] * d
    skew = geo.norm3(fg.centres - intersect) / dn.clamp_min(VSMALL)
    skew = torch.where(has_n & ok, skew, 0.0)

    # Face-face angles over all edges (no substitution)
    emin, emax = _edge_face_angle_extrema(points, cell_ctrs, td, fg.means,
                                          edge_claim)

    # Edge lengths
    e = td["edges"].long()
    elen = geo.norm3(points[e[:, 1]] - points[e[:, 0]])
    if edge_claim is not None:
        elen = torch.where(edge_claim, elen, math.nan)

    # Cell closedness + aspect ratio (OpenFOAM checkMesh
    # primitiveMeshCheck: checkClosedCells).  Openness = |net signed
    # face-area sum| / total face area; aspect = (1/6) total face area
    # / V^(2/3) (== 1 for a cube).  The rows of [area vector | area]
    # per cell come through K7; the owner sign is integer and static,
    # so it stays out of the float gather.
    cf = td["cell_faces"]
    cfm = td["cell_faces_mask"]
    cell_ids = torch.arange(cf.shape[0], device=dev)[:, None]
    sign = torch.where(td["owner"].long()[cf.long()] == cell_ids,
                       1.0, -1.0).to(dtype)
    rows = table_gather(torch.cat([fg.areas, mags[:, None]], 1), cf, cfm)
    m = cfm.to(dtype)
    net = (sign[..., None] * rows[..., :3] * m[..., None]).sum(1)
    tot = (rows[..., 3] * m).sum(1)
    openness = geo.norm3(net) / tot.clamp_min(VSMALL)
    aspect = (tot / 6.0) / vols.clamp_min(VSMALL) ** (2.0 / 3.0)
    if cell_claim is not None:
        openness = torch.where(cell_claim, openness, 0.0)
        aspect = torch.where(cell_claim, aspect, 0.0)

    # Face pyramid volumes (checkFacePyramids): owner-side pyramid
    # positive, neighbour-side negative
    pyr_own = geo.dot3(fg.areas, fg.centres - own_c) / 3.0
    pyr_nei = -geo.dot3(fg.areas, fg.centres - nei_c) / 3.0
    fvalid = td["face_mask"].any(1)
    if face_claim is not None:
        fvalid = fvalid & face_claim
    pyr = torch.where(fvalid, pyr_own, inf)
    pyr = torch.minimum(pyr, torch.where(fvalid & td["has_neighbour"],
                                         pyr_nei, inf))

    if cell_claim is not None:
        vols = torch.where(cell_claim, vols, math.nan)
    vol_valid = ~torch.isnan(vols)
    e_valid = ~torch.isnan(elen)

    values = {
        "max_aspect_ratio": aspect.max(),
        "max_cell_openness": openness.max(),
        "min_pyramid_volume": pyr.min(),
        "min_face_angle_deg": torch.rad2deg(emin),
        "max_face_angle_deg": torch.rad2deg(emax),
        "max_non_ortho_deg": nonortho.max(),
        "sum_non_ortho_deg": nonortho.sum(),
        "n_internal_faces": n_int,
        "max_skewness": skew.max(),
        "min_edge_length": torch.where(e_valid, elen, inf).min(),
        "max_edge_length": torch.where(e_valid, elen, -inf).max(),
        "min_volume": torch.where(vol_valid, vols, inf).min(),
        "max_volume": torch.where(vol_valid, vols, -inf).max(),
        "total_volume": torch.where(vol_valid, vols, 0.0).sum(),
        "n_negative_volumes": (vol_valid & (vols <= 0)).sum(),
    }
    # one host read for the whole report
    host = torch.stack([v.to(torch.float64) for v in values.values()])
    out = dict(zip(values, host.tolist()))
    for k in ("n_internal_faces", "n_negative_volumes"):
        out[k] = int(out[k])
    return out


def combine_quality_parts(parts) -> Dict[str, float]:
    """Fold :func:`quality_report_parts` dicts into the report (the
    keys of :func:`quality_report`)."""
    def mn(k):
        return min(p[k] for p in parts)

    def mx(k):
        return max(p[k] for p in parts)

    def sm(k):
        return sum(p[k] for p in parts)

    n_int = sm("n_internal_faces")
    return {
        "max_aspect_ratio": mx("max_aspect_ratio"),
        "max_cell_openness": mx("max_cell_openness"),
        "min_pyramid_volume": mn("min_pyramid_volume"),
        "min_face_angle_deg": mn("min_face_angle_deg"),
        "max_face_angle_deg": mx("max_face_angle_deg"),
        "max_non_ortho_deg": mx("max_non_ortho_deg"),
        "avg_non_ortho_deg": sm("sum_non_ortho_deg") / max(n_int, 1),
        "max_skewness": mx("max_skewness"),
        "min_edge_length": mn("min_edge_length"),
        "max_edge_length": mx("max_edge_length"),
        "min_volume": mn("min_volume"),
        "max_volume": mx("max_volume"),
        "total_volume": sm("total_volume"),
        "n_negative_volumes": sm("n_negative_volumes"),
    }


def quality_report(points, td) -> Dict[str, float]:
    """The full quality metric set on the points' device, as floats."""
    return combine_quality_parts([quality_report_parts(points, td)])


def check_mesh(points, td, max_non_ortho: float = 70.0,
               max_skew: float = 4.0, max_aspect: float = 1000.0,
               max_openness: float = 1e-6) -> Dict[str, object]:
    """checkMesh-style pass/fail verdict with the standard OpenFOAM
    thresholds: non-orthogonality 70 deg, skewness 4, aspect ratio
    1000, cell openness 1e-6 (closedThreshold_), face pyramids
    positive (checkFacePyramids)."""
    rep = quality_report(points, td)
    ok = (
        rep["n_negative_volumes"] == 0
        and rep["max_non_ortho_deg"] < max_non_ortho
        and rep["max_skewness"] < max_skew
        and rep["max_aspect_ratio"] < max_aspect
        and rep["max_cell_openness"] < max_openness
        and rep["min_pyramid_volume"] > 0.0
    )
    return {"ok": bool(ok), **rep}
