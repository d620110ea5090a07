"""The predictor: centroidal + aspect-ratio smoothing, step limiter.

  - ``centroidalSmoothing``      (reference src/smoothMesh.C:96-166)
  - ``aspectRatioSmoothing`` / ``findClosestPoints`` / ``calcARSmoothingRatio``
                                 (reference src/smoothMesh.C:313-593)
  - ``constrainMaxStepLength``   (reference src/smoothMesh.C:684-754)
  - ``calculateResidual``        (reference src/smoothMesh.C:1546-1570)

The functions below are plain PyTorch over the padded device topology
(masked gathers + reductions).  :func:`predictor` is the fused stage
the driver calls: the plain chain for CPU tensors, the hand-written
kernel ``csrc/predictor.cu`` (K3, float32) for CUDA tensors.
"""

from __future__ import annotations

import torch

from smoothmesh_torch import kernels
from smoothmesh_torch.geometry import norm3

VSMALL = 1e-30


def _big(dtype) -> float:
    """Stand-in for OpenFOAM GREAT in UNDEF_VECTOR, overflow-safe per dtype."""
    return 1e18 if dtype == torch.float32 else 1e150


def centroidal_smoothing(points, cell_ctrs, td, do_boundary_smoothing):
    """Mean of surrounding cell centres per point.

    Skips boundary points (falls back to current coords) unless boundary
    smoothing is enabled, exactly like the reference's eligibility test
    (src/smoothMesh.C:114-119).  Returns the proposed point field.
    """
    pc = td["point_cells"].long()
    m = td["point_cells_mask"]
    eligible = td["is_internal_point"] | bool(do_boundary_smoothing)

    w = (m & eligible[:, None]).to(points.dtype)
    sums = (cell_ctrs[pc] * w[..., None]).sum(1)                # (N, 3)
    counts = w.sum(1)                                           # (N,)

    has = counts > 0
    return torch.where(has[:, None], sums / counts.clamp_min(1.0)[:, None],
                       points)


def _closest_three(points, td):
    """Per point: relative vectors + neighbour ids of the three closest
    edge-connected points, with the reference's boundary filtering
    (boundary points only consider boundary neighbours,
    src/smoothMesh.C:277-308).

    Ties are broken by neighbour slot order (first minimum wins).
    Missing candidates (fewer than k eligible neighbours) get an
    UNDEF-style huge vector and id -1.
    """
    big = _big(points.dtype)
    pp = td["point_points"].long()
    mask = td["point_points_mask"]
    internal = td["is_internal_point"]

    rel = points[pp] - points[:, None, :]          # (N, W, 3)
    lengths = norm3(rel)
    eligible = mask & (internal[:, None] | ~internal[pp])
    lengths = torch.where(eligible, lengths, torch.inf)

    rows = torch.arange(points.shape[0], device=points.device)
    slots = torch.arange(lengths.shape[1], device=points.device)[None, :]
    outs = []
    ids = []
    for _ in range(3):
        slot = torch.argmin(lengths, dim=1)                      # (N,)
        found = lengths[rows, slot] < torch.inf
        vec = torch.where(found[:, None], rel[rows, slot],
                          torch.full_like(points, big))
        nid = torch.where(found, pp[rows, slot], -1)
        outs.append(vec)
        ids.append(nid)
        lengths = torch.where(slots == slot[:, None], torch.inf, lengths)
    return outs, ids


def _share_cell(td, a_ids, b_ids):
    """True where points a and b share at least one cell.

    Replaces the reference's pointNeighPoints lookup
    (src/smoothMesh.C:383-386) with a set intersection over the two
    points' pointCells rows.
    """
    pc = td["point_cells"]
    pm = td["point_cells_mask"]
    a = a_ids.clamp_min(0)
    b = b_ids.clamp_min(0)
    ca, ma = pc[a], pm[a]                      # (N, W)
    cb, mb = pc[b], pm[b]
    eq = ca[:, :, None] == cb[:, None, :]
    eq &= ma[:, :, None] & mb[:, None, :]
    return eq.flatten(1).any(1) & (a_ids >= 0) & (b_ids >= 0)


def aspect_ratio_smoothing(points, centroidal_points, td):
    """Blend midpoint-of-two-closest-points with the centroidal target.

    Internal points: blend only when the two closest edge lengths are
    similar (ratio < 1.5) and the third is clearly farther (ratio in
    [1.5, 3] ramps the blend 0..1) — the reference's high-aspect-ratio
    detection (src/smoothMesh.C:489-543).  Boundary points use the
    [1.0, 2.0] ramp on the closest-two ratio.  Disabled when the two
    closest points share a cell.
    """
    (c1, c2, c3), (i1, i2, _) = _closest_three(points, td)
    has_common = _share_cell(td, i1, i2)

    internal = td["is_internal_point"]
    l1 = norm3(c1)
    l2 = norm3(c2)
    l3 = norm3(c3)
    ratio1 = l2 / l1.clamp_min(VSMALL)
    ratio2 = l3 / l2.clamp_min(VSMALL)

    # Internal-point ramp (min 1.5 -> max 3.0)
    frac_int = ((ratio2 - 1.5) / 1.5).clamp(0.0, 1.0)
    frac_int = torch.where((ratio1 < 1.5) & (ratio2 > 1.5), frac_int, 0.0)
    # Boundary-point ramp (min 1.0 -> max 2.0)
    frac_bnd = (ratio1 - 1.0).clamp(0.0, 1.0)

    frac = torch.where(internal, frac_int, frac_bnd)
    zero1 = (c1 == 0.0).all(-1) | (c2 == 0.0).all(-1)
    frac = torch.where(has_common | zero1, 0.0, frac)

    mid = points + 0.5 * (c1 + c2)
    blended = (1.0 - frac)[:, None] * centroidal_points + frac[:, None] * mid
    return torch.where((frac > 0.0)[:, None], blended, centroidal_points)


def constrain_max_step_length(points, proposed, max_step_length,
                              rel_step_frac):
    """Clamp each point's jump (reference src/smoothMesh.C:684-754,
    doGlobalScaling=false as at every live call site): steps longer than
    ``max_step_length`` are rescaled so the *applied* step equals
    exactly ``max_step_length``; shorter steps are scaled by
    ``rel_step_frac``.  The rescale applies only where the length is
    strictly greater than ``max_step_length``.
    """
    step = proposed - points
    length = norm3(step)
    scale = torch.where(
        length > max_step_length,
        max_step_length / (length.clamp_min(VSMALL) * rel_step_frac),
        1.0,
    )
    return points + (rel_step_frac * scale)[:, None] * step


def calculate_residual(points, new_points, max_step_length):
    """max |displacement| / maxStepLength over all points."""
    return norm3(new_points - points).max() / max_step_length


def predictor_plain(points, cell_ctrs, td, max_step, rel_step_frac,
                    do_boundary):
    """centroidal -> aspect-ratio blend -> step limiter, plus the
    minimum current edge length per point (what K3 computes)."""
    cent = centroidal_smoothing(points, cell_ctrs, td, do_boundary)
    prop = aspect_ratio_smoothing(points, cent, td)
    prop = constrain_max_step_length(points, prop, max_step, rel_step_frac)
    rel = points[td["point_points"].long()] - points[:, None, :]
    curmin = torch.where(td["point_points_mask"], norm3(rel),
                         torch.inf).amin(1)
    curmin = torch.where(curmin < torch.inf, curmin, _big(points.dtype))
    return prop, curmin


def predictor(points, cell_ctrs, td, max_step, rel_step_frac, do_boundary):
    """The fused predictor stage (K3): -> (proposal (N, 3), curmin (N,))."""
    dev = points.device
    if dev.type == "cpu":
        return predictor_plain(points, cell_ctrs, td, max_step,
                               rel_step_frac, do_boundary)
    if dev.type != "cuda":
        raise ValueError(f"predictor: no kernel for {dev}")
    n = points.shape[0]
    pc, pcm = td["point_cells"], td["point_cells_mask"]
    pp, ppm = td["point_points"], td["point_points_mask"]
    wc, wp = pc.shape[1], pp.shape[1]
    intern = td["is_internal_point"]
    kernels.check(points, "points", torch.float32, (n, 3), dev)
    kernels.check(cell_ctrs, "cell_ctrs", torch.float32,
                  (cell_ctrs.shape[0], 3), dev)
    kernels.check(pc, "point_cells", torch.int32, (n, wc), dev)
    kernels.check(pcm, "point_cells_mask", torch.bool, (n, wc), dev)
    kernels.check(pp, "point_points", torch.int32, (n, wp), dev)
    kernels.check(ppm, "point_points_mask", torch.bool, (n, wp), dev)
    kernels.check(intern, "is_internal_point", torch.bool, (n,), dev)
    prop = torch.empty((n, 3), dtype=torch.float32, device=dev)
    curmin = torch.empty((n,), dtype=torch.float32, device=dev)
    kernels.PREDICTOR.launch(
        points.data_ptr(), cell_ctrs.data_ptr(), pc.data_ptr(),
        pcm.data_ptr(), pp.data_ptr(), ppm.data_ptr(), intern.data_ptr(),
        n, wc, wp, float(max_step), float(rel_step_frac), int(do_boundary),
        prop.data_ptr(), curmin.data_ptr())
    return prop, curmin
