// K6: per point, the min and max of K5's per-edge u-space face angles
// over the point's edges.
//
// Replaces the TPU kernel TiledEngine._r_body
// (smoothmesh_tpu/ops/tiledstep.py:710, stage R of the tile engine);
// plain version: smoothmesh_torch/ops/constraints.py
// point_face_angles_plain (reference
// mapCurrentMinMaxFaceAnglesToPoints, src/smoothMesh.C:1252-1270).
//
// Bound: bytes.  Per point it reads its point_edges row and mask and
// gathers 8 bytes per valid edge (mostly L2 hits in RCB order); it
// writes 8 bytes.  Design: one thread per point, a gather on the
// consumer side (no scatter, no atomics), min/max in registers.  A
// point with no valid edge keeps the identity values 4 and 0, as the
// TPU kernel does.

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(smk::kBlock)
point_face_angles_kernel(const float* __restrict__ edge_u,
                         const int* __restrict__ point_edges,
                         const bool* __restrict__ pe_mask, int n_points,
                         int we, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_points) return;
  const int64_t base = static_cast<int64_t>(i) * we;
  float u_min = 4.0f;
  float u_max = 0.0f;
  for (int w = 0; w < we; ++w) {
    if (!pe_mask[base + w]) continue;
    const int64_t e = __ldg(point_edges + base + w);
    u_min = fminf(u_min, __ldg(edge_u + 2 * e));
    u_max = fmaxf(u_max, __ldg(edge_u + 2 * e + 1));
  }
  out[2 * static_cast<int64_t>(i)] = u_min;
  out[2 * static_cast<int64_t>(i) + 1] = u_max;
}

}  // namespace

extern "C" int smk_point_face_angles(const void* edge_u,
                                     const void* point_edges,
                                     const void* pe_mask, int n_points,
                                     int we, void* out, void* stream) {
  if (n_points > 0) {
    point_face_angles_kernel<<<smk::grid_for(n_points), smk::kBlock, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(edge_u),
        static_cast<const int*>(point_edges),
        static_cast<const bool*>(pe_mask), n_points, we,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
