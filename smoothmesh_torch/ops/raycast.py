"""The ray cast of boundary point smoothing (kernel K8).

Per ray (origin o, direction d): Moller-Trumbore against every
triangle of the target surface, keeping the nearest hit on each side
of o within ``max_dist`` — the brute-force replacement of the
reference's octree ``findLine`` (src/boundaryPointSmoothing.C:682-744).

  - :func:`pack_triangles`: the soup as a (9, T) array of rows
    [a; e1; e2] (vertex a, edges b - a and c - a);
  - :func:`segment_triangle_hits_plain`: plain PyTorch in K8's order of
    operations, any float dtype, in chunks of rays so that its
    (rays x triangles) intermediates stay near 1 GB;
  - :func:`segment_triangle_hits`: the wrapper: the hand-written
    kernel ``csrc/raycast.cu`` (K8) for float32 CUDA tensors, the plain
    version for CPU tensors and float64 CUDA tensors;
  - :func:`launch_geometry`: K8's grid of (ray blocks x triangle
    slices), from the card's SM count.

The barycentric tolerance depends on the dtype: a hit exactly on an
edge shared by two triangles computes u or v a few ulps outside both,
so the tolerance must exceed the rounding noise (1e-9 in float64, 1e-5
in float32, as the JAX package's ``segment_triangle_hits`` and its
Pallas kernel use).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from smoothmesh_torch import kernels

EPS = 1e-12                  # |det| below this: ray parallel to the plane
BARY = {torch.float64: 1e-9, torch.float32: 1e-5}
#: bytes of (rays x triangles) intermediates per chunk of the plain version
PLAIN_BUDGET = 1 << 30
PLAIN_LIVE = 16              # (rays x triangles) tensors alive at once
#: K8's block: threads, rays per thread, triangles per shared tile
#: (kThreads, kRays and kTile of csrc/raycast.cu)
THREADS = 128
RAYS_PER_THREAD = 2
TILE = 128
#: blocks per SM that the triangle slices aim at: about three waves of
#: the ten blocks an SM holds, the quickest of the slice counts
#: measured at 128^3 (PERF.md)
BLOCKS_PER_SM = 32


class Geometry(NamedTuple):
    """K8's launch: ``ray_blocks`` x ``slices`` blocks; block (x, y)
    casts rays [x * THREADS * RAYS_PER_THREAD, ...) against triangles
    [y * tris_per_slice, (y + 1) * tris_per_slice), both cut at their
    counts."""

    ray_blocks: int
    slices: int
    tris_per_slice: int


def launch_geometry(n_rays: int, n_tri: int, n_sm: int) -> Geometry:
    """Split the triangle loop into slices of whole tiles so that the
    (ray blocks x slices) grid holds about ``BLOCKS_PER_SM * n_sm``
    blocks, or one slice per tile where there are fewer tiles.  No
    rays: an empty grid; no triangles: no slices (only the fill runs)."""
    ray_blocks = -(-n_rays // (THREADS * RAYS_PER_THREAD))
    if ray_blocks == 0 or n_tri == 0:
        return Geometry(ray_blocks, 0, 0)
    tiles = -(-n_tri // TILE)
    want = max(1, -(-BLOCKS_PER_SM * n_sm // ray_blocks))
    tiles_per_slice = -(-tiles // min(want, tiles))
    tris_per_slice = tiles_per_slice * TILE
    return Geometry(ray_blocks, -(-n_tri // tris_per_slice), tris_per_slice)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def pack_triangles(ta, tb, tc, dtype=np.float32) -> np.ndarray:
    """(9, T) rows [a; b - a; c - a] of the triangles (a, b, c), the
    edges taken in ``dtype``."""
    ta, tb, tc = (np.asarray(x, dtype=dtype) for x in (ta, tb, tc))
    packed = np.concatenate([ta, tb - ta, tc - ta], axis=1).T
    return np.ascontiguousarray(packed)


def segment_triangle_hits_plain(orig, direction, max_dist: float,
                                tri_packed, chunk=None):
    """Nearest |t| hits of o + t*d with the soup, for t in [0, max_dist]
    and in [-max_dist, 0) -> (t_pos (B,), t_neg (B,)), +inf where none.

    ``tri_packed``: (9, T) from :func:`pack_triangles`, in the dtype of
    ``orig``.  ``chunk``: rays per chunk (default: the memory budget).
    """
    dtype = orig.dtype
    bary = BARY[dtype]
    B = orig.shape[0]
    T = tri_packed.shape[1]
    t_pos = torch.full((B,), torch.inf, dtype=dtype, device=orig.device)
    t_neg = torch.full((B,), torch.inf, dtype=dtype, device=orig.device)
    if B == 0 or T == 0:
        return t_pos, t_neg
    if chunk is None:
        chunk = max(1, PLAIN_BUDGET // (PLAIN_LIVE * T * orig.element_size()))
    ax, ay, az, e1x, e1y, e1z, e2x, e2y, e2z = (r[None, :]
                                                for r in tri_packed)
    for s in range(0, B, chunk):
        ox, oy, oz = orig[s:s + chunk, :, None].unbind(1)      # (Q, 1)
        dx, dy, dz = direction[s:s + chunk, :, None].unbind(1)
        # p = d x e2
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        ok = det.abs() > EPS
        inv = 1.0 / torch.where(ok, det, 1.0)
        sx = ox - ax
        sy = oy - ay
        sz = oz - az
        u = (sx * px + sy * py + sz * pz) * inv
        # q = s x e1
        qx = sy * e1z - sz * e1y
        qy = sz * e1x - sx * e1z
        qz = sx * e1y - sy * e1x
        v = (dx * qx + dy * qy + dz * qz) * inv
        t = (e2x * qx + e2y * qy + e2z * qz) * inv
        ok &= (u >= -bary) & (v >= -bary) & (u + v <= 1 + bary)
        t = torch.where(ok, t, torch.inf)
        t_pos[s:s + chunk] = torch.where((t >= 0) & (t <= max_dist), t,
                                         torch.inf).amin(1)
        t_neg[s:s + chunk] = torch.where((t < 0) & (t >= -max_dist), -t,
                                         torch.inf).amin(1)
    return t_pos, t_neg


def segment_triangle_hits(orig, direction, max_dist: float, tri_packed):
    """The ray cast (K8): -> (t_pos (B,), t_neg (B,)), +inf where none."""
    dev = orig.device
    if not kernels.takes_kernel(dev, orig.dtype, "segment_triangle_hits"):
        return segment_triangle_hits_plain(orig, direction, max_dist,
                                           tri_packed)
    n_rays, n_tri = orig.shape[0], tri_packed.shape[1]
    kernels.check(orig, "orig", torch.float32, (n_rays, 3), dev)
    kernels.check(direction, "direction", torch.float32, (n_rays, 3), dev)
    kernels.check(tri_packed, "tri_packed", torch.float32, (9, n_tri), dev)
    bary = BARY[torch.float32]
    g = launch_geometry(n_rays, n_tri, _sm_count(
        dev.index if dev.index is not None else torch.cuda.current_device()))
    t_pos = torch.empty((n_rays,), dtype=torch.float32, device=dev)
    t_neg = torch.empty((n_rays,), dtype=torch.float32, device=dev)
    kernels.RAYCAST.launch(
        orig.data_ptr(), direction.data_ptr(), tri_packed.data_ptr(),
        n_rays, n_tri, g.ray_blocks, g.slices, g.tris_per_slice,
        float(max_dist), EPS, bary, 1.0 + bary,
        t_pos.data_ptr(), t_neg.data_ptr(), device=t_pos.device)
    return t_pos, t_neg
