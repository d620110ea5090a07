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
  - :func:`segment_triangle_hits`: the wrapper: the plain version for
    CPU tensors, the hand-written kernel ``csrc/raycast.cu`` (K8,
    float32) for CUDA tensors.

The barycentric tolerance depends on the dtype: a hit exactly on an
edge shared by two triangles computes u or v a few ulps outside both,
so the tolerance must exceed the rounding noise (1e-9 in float64, 1e-5
in float32, as the JAX package's ``segment_triangle_hits`` and its
Pallas kernel use).
"""

from __future__ import annotations

import numpy as np
import torch

from smoothmesh_torch import kernels

EPS = 1e-12                  # |det| below this: ray parallel to the plane
BARY = {torch.float64: 1e-9, torch.float32: 1e-5}
#: bytes of (rays x triangles) intermediates per chunk of the plain version
PLAIN_BUDGET = 1 << 30
PLAIN_LIVE = 16              # (rays x triangles) tensors alive at once


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
    if dev.type == "cpu":
        return segment_triangle_hits_plain(orig, direction, max_dist,
                                           tri_packed)
    if dev.type != "cuda":
        raise ValueError(f"segment_triangle_hits: no kernel for {dev}")
    n_rays, n_tri = orig.shape[0], tri_packed.shape[1]
    kernels.check(orig, "orig", torch.float32, (n_rays, 3), dev)
    kernels.check(direction, "direction", torch.float32, (n_rays, 3), dev)
    kernels.check(tri_packed, "tri_packed", torch.float32, (9, n_tri), dev)
    bary = BARY[torch.float32]
    t_pos = torch.empty((n_rays,), dtype=torch.float32, device=dev)
    t_neg = torch.empty((n_rays,), dtype=torch.float32, device=dev)
    kernels.RAYCAST.launch(
        orig.data_ptr(), direction.data_ptr(), tri_packed.data_ptr(),
        n_rays, n_tri, float(max_dist), EPS, bary, 1.0 + bary,
        t_pos.data_ptr(), t_neg.data_ptr())
    return t_pos, t_neg
