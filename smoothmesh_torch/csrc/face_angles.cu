// K5: per edge, the u-space min and max of the face-face angle sum over
// the edge's cells (the current angles, no substitution).
//
// Replaces the TPU kernel TiledEngine._e_body
// (smoothmesh_tpu/ops/tiledstep.py:640, stage E of the tile engine);
// plain version: smoothmesh_torch/ops/constraints.py
// edge_face_angles_plain (reference calcMinMaxFaceAngleForEdge,
// src/smoothMesh.C:1135-1231).
//
// Per valid cell slot u of edge e: the vertex means of the two faces of
// that cell around e (slots f0[u], f1[u] of the edge's edge_faces row)
// and the cell centre are projected onto the plane through the edge's
// midpoint normal to the edge; the angle is the sum of the two
// face->cell angles, encoded as u = 1 - cos(A+B) when sin(A+B) >= 0,
// else 3 + cos(A+B), with both cosines clamped to +-0.99999.  u is
// strictly increasing in the angle on [0, 2 pi], so min/max and the
// fixed point's threshold tests agree with angle space; it is continuous
// at pi (both branches give 2 there), so a last-bit difference of the
// sine cannot jump it.
//
// Bound: bytes.  Per edge it reads its endpoints, its edge_cells,
// f0/f1 and mask rows, and per valid cell two face ids, two vertex
// means and one cell centre (mostly L2 hits in RCB order); it writes
// 8 bytes.  Design: one thread per edge, the faces projected again for
// each cell that reads them (a projection is a pure function of the
// face mean and the edge, so the result is the same as projecting each
// face once), min/max in registers.  Invalid cell slots and
// out-of-range face slots are skipped before any load.

#include "common.cuh"

namespace {

using smk::V3;

// Unit vector from ctr to x projected onto the plane through ctr normal
// to the unit vector ev.
__device__ __forceinline__ V3 proj_unit(V3 ctr, V3 ev, V3 x) {
  const float dt = smk::dot(smk::sub(ctr, x), ev);
  const V3 d = smk::sub(smk::add(x, smk::scale(dt, ev)), ctr);
  const float dn = fmaxf(smk::norm(d), smk::kVSmall);
  return V3{d.x / dn, d.y / dn, d.z / dn};
}

__device__ __forceinline__ float clamp_cos(float c) {
  return fminf(fmaxf(c, -smk::kAcosClamp), smk::kAcosClamp);
}

__global__ void __launch_bounds__(smk::kBlock)
face_angles_kernel(const float* __restrict__ points,
                   const float* __restrict__ means,
                   const float* __restrict__ cell_ctrs,
                   const int* __restrict__ edges,
                   const int* __restrict__ edge_faces,
                   const int* __restrict__ edge_cells,
                   const int* __restrict__ cell_f0,
                   const int* __restrict__ cell_f1,
                   const bool* __restrict__ cell_mask, int n_edges, int wf,
                   int wc, float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_edges) return;
  const V3 e0 = smk::load3(points, __ldg(edges + 2 * static_cast<int64_t>(e)));
  const V3 e1 =
      smk::load3(points, __ldg(edges + 2 * static_cast<int64_t>(e) + 1));
  const V3 ctr = smk::scale(0.5f, smk::add(e0, e1));
  V3 ev = smk::sub(e1, e0);
  const float en = fmaxf(smk::norm(ev), smk::kVSmall);
  ev = V3{ev.x / en, ev.y / en, ev.z / en};

  const int* frow = edge_faces + static_cast<int64_t>(e) * wf;
  const int64_t cbase = static_cast<int64_t>(e) * wc;
  float u_min = 4.0f;
  float u_max = 0.0f;
  for (int u = 0; u < wc; ++u) {
    if (!cell_mask[cbase + u]) continue;
    const int s0 = __ldg(cell_f0 + cbase + u);
    const int s1 = __ldg(cell_f1 + cbase + u);
    if (s0 < 0 || s0 >= wf || s1 < 0 || s1 >= wf) continue;
    const V3 p0 = proj_unit(ctr, ev, smk::load3(means, __ldg(frow + s0)));
    const V3 p1 = proj_unit(ctr, ev, smk::load3(means, __ldg(frow + s1)));
    const V3 cv =
        proj_unit(ctr, ev, smk::load3(cell_ctrs, __ldg(edge_cells + cbase + u)));
    const float a = clamp_cos(smk::dot(p0, cv));
    const float b = clamp_cos(smk::dot(cv, p1));
    const float sa = sqrtf(1.0f - a * a);
    const float sb = sqrtf(1.0f - b * b);
    const float cos_s = a * b - sa * sb;
    const float sin_s = sa * b + a * sb;
    const float uv = sin_s >= 0.0f ? 1.0f - cos_s : 3.0f + cos_s;
    u_min = fminf(u_min, uv);
    u_max = fmaxf(u_max, uv);
  }
  out[2 * static_cast<int64_t>(e)] = u_min;
  out[2 * static_cast<int64_t>(e) + 1] = u_max;
}

}  // namespace

extern "C" int smk_face_angles(const void* points, const void* means,
                               const void* cell_ctrs, const void* edges,
                               const void* edge_faces, const void* edge_cells,
                               const void* cell_f0, const void* cell_f1,
                               const void* cell_mask, int n_edges, int wf,
                               int wc, void* out, void* stream) {
  if (n_edges > 0) {
    face_angles_kernel<<<smk::grid_for(n_edges), smk::kBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(points), static_cast<const float*>(means),
        static_cast<const float*>(cell_ctrs), static_cast<const int*>(edges),
        static_cast<const int*>(edge_faces),
        static_cast<const int*>(edge_cells), static_cast<const int*>(cell_f0),
        static_cast<const int*>(cell_f1), static_cast<const bool*>(cell_mask),
        n_edges, wf, wc, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
