"""The predictor: centroidal + aspect-ratio smoothing, step limiter.

  - ``centroidalSmoothing``      (reference src/smoothMesh.C:96-166)
  - ``aspectRatioSmoothing`` / ``findClosestPoints`` / ``calcARSmoothingRatio``
                                 (reference src/smoothMesh.C:313-593)
  - ``constrainMaxStepLength``   (reference src/smoothMesh.C:684-754)
  - ``calculateResidual``        (reference src/smoothMesh.C:1546-1570)

The functions below are plain PyTorch over the padded device topology
(masked gathers + reductions).  :func:`predictor` is the fused stage
the driver calls: the hand-written kernel ``csrc/predictor.cu`` (K3)
for float32 CUDA tensors, the plain chain for CPU tensors and float64
CUDA tensors (``kernels.takes_kernel``).
"""

from __future__ import annotations

import torch

from smoothmesh_torch import kernels
from smoothmesh_torch.geometry import norm3

VSMALL = 1e-30


def _big(dtype) -> float:
    """Stand-in for OpenFOAM GREAT in UNDEF_VECTOR, overflow-safe per dtype."""
    return 1e18 if dtype == torch.float32 else 1e150


def _centroid_sums(points, cell_ctrs, td, do_boundary_smoothing, rows=None):
    """The sums and counts of the eligible cell centres around each
    point (of the points ``rows`` only, where given)."""
    pc = td["point_cells"]
    m = td["point_cells_mask"]
    internal = td["is_internal_point"]
    if rows is not None:
        pc, m, internal = pc[rows], m[rows], internal[rows]
    eligible = internal | bool(do_boundary_smoothing)
    w = (m & eligible[:, None]).to(points.dtype)
    sums = (cell_ctrs[pc.long()] * w[..., None]).sum(1)         # (N, 3)
    counts = w.sum(1)                                           # (N,)
    return sums, counts


def _centroids(points, sums, counts):
    has = counts > 0
    return torch.where(has[:, None], sums / counts.clamp_min(1.0)[:, None],
                       points)


def centroidal_smoothing(points, cell_ctrs, td, do_boundary_smoothing,
                         sync=None):
    """Mean of surrounding cell centres per point.

    Skips boundary points (falls back to current coords) unless boundary
    smoothing is enabled, exactly like the reference's eligibility test
    (src/smoothMesh.C:114-119).  Returns the proposed point field.
    ``sync``: the disjoint decomposition's exchange
    (``parallel.sync.UnionPointSync``/``DistPointSync``) or None; the
    sums and the counts of a shared point are summed over its holders
    before the division.
    """
    sums, counts = _centroid_sums(points, cell_ctrs, td,
                                  do_boundary_smoothing)
    if sync is not None:
        sums = sync.sum(sums)
        counts = sync.sum(counts)
    return _centroids(points, sums, counts)


def _closest_three(points, td, rows=None):
    """Per point: relative vectors + neighbour ids of the three closest
    edge-connected points, with the reference's boundary filtering
    (boundary points only consider boundary neighbours,
    src/smoothMesh.C:277-308); of the points ``rows`` only, where given.

    Ties are broken by neighbour slot order (first minimum wins).
    Missing candidates (fewer than k eligible neighbours) get an
    UNDEF-style huge vector and id -1.
    """
    big = _big(points.dtype)
    pp = td["point_points"]
    mask = td["point_points_mask"]
    internal = td["is_internal_point"]
    own, own_internal = points, internal
    if rows is not None:
        pp, mask = pp[rows], mask[rows]
        own, own_internal = points[rows], internal[rows]
    pp = pp.long()

    rel = points[pp] - own[:, None, :]             # (N, W, 3)
    lengths = norm3(rel)
    eligible = mask & (own_internal[:, None] | ~internal[pp])
    lengths = torch.where(eligible, lengths, torch.inf)

    rows = torch.arange(own.shape[0], device=points.device)
    slots = torch.arange(lengths.shape[1], device=points.device)[None, :]
    outs = []
    ids = []
    for _ in range(3):
        slot = torch.argmin(lengths, dim=1)                      # (N,)
        found = lengths[rows, slot] < torch.inf
        vec = torch.where(found[:, None], rel[rows, slot],
                          torch.full_like(own, big))
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


def _ratio_fraction(c1, c2, c3, internal):
    """The aspect-ratio blend fraction from the three closest vectors,
    before the share-a-cell test (0 where either of the two closest is
    zero)."""
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
    return torch.where(zero1, 0.0, frac)


def _blend_fraction(points, td):
    """The aspect-ratio blend fraction before the share-a-cell test,
    with the two closest vectors and their neighbour ids."""
    (c1, c2, c3), (i1, i2, _) = _closest_three(points, td)
    frac = _ratio_fraction(c1, c2, c3, td["is_internal_point"])
    return frac, c1, c2, i1, i2


def share_test_mask(points, td):
    """The points where K3 runs the share-a-cell test: those whose blend
    fraction is positive before it (the test can only zero it) and that
    have two closest neighbours."""
    frac, _, _, i1, i2 = _blend_fraction(points, td)
    return (frac > 0.0) & (i1 >= 0) & (i2 >= 0)


def aspect_ratio_smoothing(points, centroidal_points, td, sync=None):
    """Blend midpoint-of-two-closest-points with the centroidal target.

    Internal points: blend only when the two closest edge lengths are
    similar (ratio < 1.5) and the third is clearly farther (ratio in
    [1.5, 3] ramps the blend 0..1) — the reference's high-aspect-ratio
    detection (src/smoothMesh.C:489-543).  Boundary points use the
    [1.0, 2.0] ramp on the closest-two ratio.  Disabled when the two
    closest points share a cell.  ``sync``: the disjoint
    decomposition's exchange or None; each holder of a shared point
    then merges its three closest with the other holders' (the
    reference's closest-point cascade, ``sync.closest_points``).
    """
    (c1, c2, c3), (i1, i2, _) = _closest_three(points, td)
    has_common = _share_cell(td, i1, i2)
    if sync is not None:
        c1, c2, c3, has_common = sync.closest_points(c1, c2, c3, has_common)
    frac = _ratio_fraction(c1, c2, c3, td["is_internal_point"])
    frac = torch.where(has_common, 0.0, frac)
    return _blend(points, centroidal_points, frac, c1, c2)


def _blend(points, centroidal_points, frac, c1, c2):
    """The midpoint of the two closest blended in by ``frac``."""
    mid = points + 0.5 * (c1 + c2)
    blended = (1.0 - frac)[:, None] * centroidal_points + frac[:, None] * mid
    return torch.where((frac > 0.0)[:, None], blended, centroidal_points)


def get_proposed_max_step_length(points, proposed, sync=None):
    """The largest proposed jump over all points (reference
    getProposedMaxStepLength src/smoothMesh.C:657-676), all-reduced
    over the shards by ``sync``."""
    m = norm3(proposed - points).max()
    return m if sync is None else sync.all_max(m)


def constrain_max_step_length(points, proposed, max_step_length,
                              rel_step_frac, do_global_scaling=False,
                              sync=None):
    """Clamp each point's jump (reference src/smoothMesh.C:684-754).

    The live call sites use doGlobalScaling=false: steps longer than
    ``max_step_length`` are rescaled so the *applied* step equals
    exactly ``max_step_length``; shorter steps are scaled by
    ``rel_step_frac``.  The rescale applies only where the length is
    strictly greater than ``max_step_length``.  ``do_global_scaling``:
    one common factor from the largest proposed jump over all points
    (:707-715), all-reduced by ``sync``.
    """
    step = proposed - points
    length = norm3(step)
    if do_global_scaling:
        proposed_max = get_proposed_max_step_length(points, proposed, sync)
        gscale = (max_step_length / (proposed_max * rel_step_frac)
                  .clamp_min(VSMALL)).clamp(max=1.0)
        scale = gscale.expand_as(length)
    else:
        scale = torch.where(
            length > max_step_length,
            max_step_length / (length.clamp_min(VSMALL) * rel_step_frac),
            1.0,
        )
    return points + (rel_step_frac * scale)[:, None] * step


def calculate_residual(points, new_points, max_step_length, sync=None):
    """max |displacement| / maxStepLength over all points, all-reduced
    over the shards by ``sync``."""
    res = norm3(new_points - points).max() / max_step_length
    return res if sync is None else sync.all_max(res)


def predictor_plain(points, cell_ctrs, td, max_step, rel_step_frac,
                    do_boundary, sync=None):
    """centroidal -> aspect-ratio blend -> step limiter, plus the
    minimum current edge length per point (what K3 computes).  ``sync``:
    the disjoint decomposition's exchange or None; the centroidal sums
    and the closest points then combine over a shared point's holders,
    which take the owner's proposal before the limiter (the JAX
    driver's order, ``smoothmesh_tpu/driver.py:150-157``)."""
    cent = centroidal_smoothing(points, cell_ctrs, td, do_boundary, sync)
    prop = aspect_ratio_smoothing(points, cent, td, sync)
    if sync is not None:
        prop = sync.consensus(prop)
    prop = constrain_max_step_length(points, prop, max_step, rel_step_frac)
    rel = points[td["point_points"].long()] - points[:, None, :]
    curmin = torch.where(td["point_points_mask"], norm3(rel),
                         torch.inf).amin(1)
    curmin = torch.where(curmin < torch.inf, curmin, _big(points.dtype))
    return prop, curmin


def predict_shared_rows(prop, points, cell_ctrs, td, max_step,
                        rel_step_frac, do_boundary, sync):
    """``prop`` (the predictor's proposal on every row of the disjoint
    decomposition's shards) with the rows of the shared points
    (``sync.rows``, one a holder) recomputed through the plain chain
    with the exchanges: the centroidal sums over the holders, the
    closest-point cascade, the owner's proposal, the step limiter.

    Off those rows the proposal needs no exchange: a point that no
    other shard holds has all its cells and edge neighbours on its own
    shard, and the limiter works point by point, so the single-shard
    predictor (K3 on the card) is exact there.  The rows here equal the
    same rows of :func:`predictor_plain` with ``sync``.
    """
    rows = sync.rows
    own = points[rows]
    sums, counts = _centroid_sums(points, cell_ctrs, td, do_boundary, rows)
    cent = _centroids(own, sync.pair_sum(sums), sync.pair_sum(counts))
    (c1, c2, c3), (i1, i2, _) = _closest_three(points, td, rows)
    c1, c2, c3, has_common = sync.pair_closest_points(
        c1, c2, c3, _share_cell(td, i1, i2))
    frac = _ratio_fraction(c1, c2, c3, td["is_internal_point"][rows])
    frac = torch.where(has_common, 0.0, frac)
    p = sync.pair_consensus(_blend(own, cent, frac, c1, c2))
    p = constrain_max_step_length(own, p, max_step, rel_step_frac)
    return prop.index_copy(0, rows, p)


def predictor(points, cell_ctrs, td, max_step, rel_step_frac, do_boundary):
    """The fused predictor stage (K3): -> (proposal (N, 3), curmin (N,))."""
    dev = points.device
    if not kernels.takes_kernel(dev, points.dtype, "predictor"):
        return predictor_plain(points, cell_ctrs, td, max_step,
                               rel_step_frac, do_boundary)
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
        prop.data_ptr(), curmin.data_ptr(), device=prop.device)
    return prop, curmin
