"""Host-side scattering of globally computed layer and boundary set-up
into per-shard blocks (numpy; the JAX package's
``smoothmesh_tpu.parallel.scatter``, same results, less the boundary
pass's padded compaction rows and triangle count, which the
decompositions' smoother takes from its union).

The decompositions compute the one-time set-up structures globally on the
host (hop counts, prismatic maps, boundary classification; the
reference, src/smoothMesh.C:2190-2230, computes them per rank with
syncs) and restrict them to each shard's local point set, given by the
shard's ``l2g`` map (local point -> global point).  Blocks are
``(D, n_padded, ...)``; rows past a shard's point count hold the fill.
"""

from __future__ import annotations

from typing import List

import numpy as np


def restrict_flags(glob, l2gs: List[np.ndarray], n_padded: int,
                   fill=False) -> np.ndarray:
    """Per-point global array -> (D, n_padded) per-shard blocks."""
    glob = np.asarray(glob)
    D = len(l2gs)
    out = np.full((D, n_padded), fill, dtype=glob.dtype)
    for d, gids in enumerate(l2gs):
        out[d, :len(gids)] = glob[gids]
    return out


def restrict_vectors(glob, l2gs: List[np.ndarray], n_padded: int,
                     fill=0.0) -> np.ndarray:
    glob = np.asarray(glob)
    D = len(l2gs)
    out = np.full((D, n_padded) + glob.shape[1:], fill, dtype=glob.dtype)
    for d, gids in enumerate(l2gs):
        out[d, :len(gids)] = glob[gids]
    return out


def g2l_maps(l2gs: List[np.ndarray], n_global: int) -> List[np.ndarray]:
    out = []
    for gids in l2gs:
        g2l = np.full(n_global, -1, dtype=np.int64)
        g2l[gids] = np.arange(len(gids))
        out.append(g2l)
    return out


def restrict_point_map(glob_map, l2gs, g2ls, n_padded: int) -> np.ndarray:
    """Global point->point map -> per-shard local map; targets absent
    from a shard become -1 (resolved per iteration through the
    min-magnitude halo combine, reference oBB.C:464-501)."""
    D = len(l2gs)
    out = np.full((D, n_padded), -1, dtype=np.int32)
    for d, gids in enumerate(l2gs):
        tgt = glob_map[gids]
        out[d, :len(gids)] = np.where(
            tgt >= 0, g2ls[d][np.maximum(tgt, 0)], -1)
    return out


def scatter_layer_maps(maps, l2gs, g2ls, n_padded: int):
    """LayerMaps -> host-side per-shard layer dict + initial normals."""
    return (
        {"hops_layer": restrict_flags(
            maps.hops_layer, l2gs, n_padded, fill=-1).astype(np.int32),
         "outer_map": restrict_point_map(
            maps.outer_map, l2gs, g2ls, n_padded)},
        restrict_vectors(maps.normals_init, l2gs, n_padded),
    )


def local_feat_tables(setup, local_topos, l2gs, n_padded: int):
    """Feature-point neighbour tables from each shard's LOCAL adjacency
    + the global classification flags (reference
    findNeighborSurfacePoints runs per rank, bPS.C:592-616)."""
    D = len(l2gs)
    W = max(t.point_points.shape[1] for t in local_topos)
    feat_n = np.zeros((D, n_padded, W), dtype=np.int32)
    feat_m = np.zeros((D, n_padded, W), dtype=bool)
    for d, gids in enumerate(l2gs):
        n = len(gids)
        lt = local_topos[d]
        pp = lt.point_points[:n]
        ppm = lt.point_points_mask[:n]
        gpp = gids[pp]
        ok = (ppm & ~lt.is_internal_point[:n][pp]
              & ~setup.is_feature_edge[gpp] & ~setup.is_corner[gpp]
              & setup.is_feature_edge[gids][:, None])
        feat_n[d, :n, :pp.shape[1]] = np.where(ok, pp, 0)
        feat_m[d, :n, :pp.shape[1]] = ok
    return feat_n, feat_m


def scatter_boundary_setup(setup, maps, l2gs, g2ls, local_topos,
                           n_padded: int, transform, scale: float):
    """Boundary classification + target geometry -> host-side dicts.

    Returns ``(bnd_shard, bnd_replicated, scalars)``: per-shard (D, ...)
    blocks, shard-replicated target geometry, and the scalar statics.
    Callers put them on device with their own shardings and dtypes.
    """
    t = transform
    bnd_shard = {
        "is_corner": restrict_flags(setup.is_corner, l2gs, n_padded),
        "is_feature_edge": restrict_flags(
            setup.is_feature_edge, l2gs, n_padded),
        "is_smoothing_surface": restrict_flags(
            setup.is_smoothing_surface, l2gs, n_padded),
        "is_connected": restrict_flags(
            setup.is_connected, l2gs, n_padded),
        "smoothing_surface": restrict_flags(
            setup.is_smoothing_surface, l2gs, n_padded),
        "point_strings": restrict_flags(
            setup.point_strings, l2gs, n_padded, fill=-1).astype(
                np.int32),
        "corner_targets": restrict_vectors(
            t(setup.corner_targets), l2gs, n_padded, fill=1e18),
        "inner_map": restrict_point_map(
            maps.inner_map, l2gs, g2ls, n_padded),
    }
    feat_n, feat_m = local_feat_tables(setup, local_topos, l2gs, n_padded)
    bnd_shard["feat_neigh"] = feat_n
    bnd_shard["feat_neigh_mask"] = feat_m

    bnd_rep = {
        "edge_a": t(setup.target_edge_points[setup.target_edges[:, 0]]),
        "edge_b": t(setup.target_edge_points[setup.target_edges[:, 1]]),
        "edge_strings": np.asarray(setup.target_edge_strings,
                                   dtype=np.int32),
        "tri_a": t(setup.surf_tri_a),
        "tri_b": t(setup.surf_tri_b),
        "tri_c": t(setup.surf_tri_c),
    }
    scalars = {
        "distance_tolerance": float(setup.distance_tolerance * scale),
    }
    return bnd_shard, bnd_rep, scalars
