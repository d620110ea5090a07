// K8: per ray, the nearest Moller-Trumbore hit against a whole triangle
// soup, on each side of the ray's origin: the nearest t in
// [0, max_dist] (t_pos) and the nearest -t in (0, max_dist] for
// t < 0 (t_neg), +inf where there is none.
//
// Replaces the TPU kernel _kernel / _cast
// (smoothmesh_tpu/ops/raycast.py:28, :101); plain version:
// smoothmesh_torch/ops/raycast.py segment_triangle_hits_plain (the
// brute-force replacement of the reference's octree findLine,
// src/boundaryPointSmoothing.C:682-744).
//
// Bound: operations.  Every ray meets every triangle: rays x triangles
// tests of 56 fp32 operations each (27 multiplies, 18 adds, a division,
// 8 comparisons, an abs and a select), against (rays + triangles) x
// 12-36 bytes of traffic.  Design: one thread per
// ray, origin and direction in registers; each block stages tiles of
// kTile triangles (9 floats each: vertex a, edges e1 and e2, stored as
// 9 rows of n_tri) in shared memory, and every thread tests its ray
// against the whole tile, read as broadcasts, keeping the running t_pos
// and t_neg in registers.  Ray and triangle indices are guarded, so
// nothing is padded.  The operations and their order are those of the
// plain version, and the constants (eps, the barycentric tolerance and
// max_dist) come from the wrapper as float32, so the two agree to the
// last bit.

#include "common.cuh"

namespace {

constexpr int kTile = smk::kBlock;   // triangles per shared-memory tile

__global__ void __launch_bounds__(smk::kBlock)
raycast_kernel(const float* __restrict__ orig, const float* __restrict__ dir,
               const float* __restrict__ tri, int n_rays, int n_tri,
               float max_dist, float eps, float bary, float bary_hi,
               float* __restrict__ t_pos, float* __restrict__ t_neg) {
  __shared__ float s[9][kTile];
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = r < n_rays;
  smk::V3 o{0.f, 0.f, 0.f}, d{0.f, 0.f, 0.f};
  if (live) {
    o = smk::load3(orig, r);
    d = smk::load3(dir, r);
  }
  const float inf = __int_as_float(0x7f800000);
  float tp = inf;
  float tn = inf;
  for (int base = 0; base < n_tri; base += kTile) {
    const int k = base + threadIdx.x;
    if (k < n_tri) {
#pragma unroll
      for (int c = 0; c < 9; ++c) {
        s[c][threadIdx.x] = __ldg(tri + static_cast<int64_t>(c) * n_tri + k);
      }
    }
    __syncthreads();
    const int m = min(kTile, n_tri - base);
    if (live) {
#pragma unroll 4
      for (int j = 0; j < m; ++j) {
        const float ax = s[0][j], ay = s[1][j], az = s[2][j];
        const float e1x = s[3][j], e1y = s[4][j], e1z = s[5][j];
        const float e2x = s[6][j], e2y = s[7][j], e2z = s[8][j];
        // p = d x e2
        const float px = d.y * e2z - d.z * e2y;
        const float py = d.z * e2x - d.x * e2z;
        const float pz = d.x * e2y - d.y * e2x;
        const float det = e1x * px + e1y * py + e1z * pz;
        const bool ok_det = fabsf(det) > eps;
        const float inv = 1.0f / (ok_det ? det : 1.0f);
        const float sx = o.x - ax;
        const float sy = o.y - ay;
        const float sz = o.z - az;
        const float u = (sx * px + sy * py + sz * pz) * inv;
        // q = s x e1
        const float qx = sy * e1z - sz * e1y;
        const float qy = sz * e1x - sx * e1z;
        const float qz = sx * e1y - sy * e1x;
        const float v = (d.x * qx + d.y * qy + d.z * qz) * inv;
        const float t = (e2x * qx + e2y * qy + e2z * qz) * inv;
        if (ok_det && u >= -bary && v >= -bary && u + v <= bary_hi) {
          if (t >= 0.0f && t <= max_dist) tp = fminf(tp, t);
          if (t < 0.0f && t >= -max_dist) tn = fminf(tn, -t);
        }
      }
    }
    __syncthreads();
  }
  if (live) {
    t_pos[r] = tp;
    t_neg[r] = tn;
  }
}

}  // namespace

extern "C" int smk_raycast(const void* orig, const void* dir, const void* tri,
                           int n_rays, int n_tri, float max_dist, float eps,
                           float bary, float bary_hi, void* t_pos,
                           void* t_neg, void* stream) {
  if (n_rays > 0) {
    raycast_kernel<<<smk::grid_for(n_rays), smk::kBlock, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(orig), static_cast<const float*>(dir),
        static_cast<const float*>(tri), n_rays, n_tri, max_dist, eps, bary,
        bary_hi, static_cast<float*>(t_pos), static_cast<float*>(t_neg));
  }
  return static_cast<int>(cudaGetLastError());
}
