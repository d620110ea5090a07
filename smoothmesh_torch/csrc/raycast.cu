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
// 12-36 bytes of traffic.  With --fmad=false every multiply and add
// issues on its own, so the issue rate, not the FMA rate, is the
// ceiling.
//
// Design: a 2-D grid of (ray blocks x triangle slices), sized by the
// wrapper (ops/raycast.py launch_geometry) from the card's SM count so
// that a few thousand rays fill every SM; the triangle loop is split
// across blocks and the per-slice minima are combined exactly by
// atomicMin on the bit patterns of the non-negative results (a minimum
// is order-free, so the result does not depend on scheduling; a zero is
// written as +0).  Each thread keeps kRays rays in registers, so each
// triangle read from shared memory (three 16-byte broadcasts) serves
// kRays tests and the independent chains hide each other's latency
// (2 rays: 48 registers; 4 were slower at every slice count measured).  Each
// block stages its slice's triangles in tiles of kTile in shared
// memory.  Ray and triangle indices are guarded, so nothing is padded.
// A first small kernel fills both outputs with +inf; with no triangles
// it is the only launch.  The operations of a test and their order are
// those of the plain version, and the constants (eps, the barycentric
// tolerance and max_dist) come from the wrapper as float32, so the two
// agree to the last bit.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;        // threads per block
constexpr int kRays = 2;             // rays per thread (R)
constexpr int kTile = kThreads;      // triangles per shared-memory tile

__global__ void __launch_bounds__(kThreads)
fill_inf(float* __restrict__ t_pos, float* __restrict__ t_neg, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    t_pos[i] = __int_as_float(0x7f800000);
    t_neg[i] = __int_as_float(0x7f800000);
  }
}

// the minimum of a non-negative float and *addr, exactly (non-negative
// floats order as their bit patterns do); v is never -0
__device__ __forceinline__ void min_nonneg(float* addr, float v) {
  atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
}

__global__ void __launch_bounds__(kThreads)
raycast_kernel(const float* __restrict__ orig, const float* __restrict__ dir,
               const float* __restrict__ tri, int n_rays, int n_tri,
               int tris_per_slice, float max_dist, float eps, float bary,
               float bary_hi, float* __restrict__ t_pos,
               float* __restrict__ t_neg) {
  // triangle j of the tile: (ax ay az e1x) (e1y e1z e2x e2y) (e2z - - -)
  __shared__ float4 s[kTile][3];
  const float inf = __int_as_float(0x7f800000);
  const int ray0 = blockIdx.x * (kThreads * kRays) + threadIdx.x;
  float ox[kRays], oy[kRays], oz[kRays], dx[kRays], dy[kRays], dz[kRays];
  float tp[kRays], tn[kRays];
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const int r = ray0 + k * kThreads;
    smk::V3 o{0.f, 0.f, 0.f}, d{0.f, 0.f, 0.f};
    if (r < n_rays) {
      o = smk::load3(orig, r);
      d = smk::load3(dir, r);
    }
    ox[k] = o.x; oy[k] = o.y; oz[k] = o.z;
    dx[k] = d.x; dy[k] = d.y; dz[k] = d.z;
    tp[k] = inf;
    tn[k] = inf;
  }
  const int t_begin = blockIdx.y * tris_per_slice;
  const int t_end = min(n_tri, t_begin + tris_per_slice);
  for (int base = t_begin; base < t_end; base += kTile) {
    const int k = base + threadIdx.x;
    if (k < t_end) {
      float v[9];
#pragma unroll
      for (int c = 0; c < 9; ++c) {
        v[c] = __ldg(tri + static_cast<int64_t>(c) * n_tri + k);
      }
      s[threadIdx.x][0] = make_float4(v[0], v[1], v[2], v[3]);
      s[threadIdx.x][1] = make_float4(v[4], v[5], v[6], v[7]);
      s[threadIdx.x][2] = make_float4(v[8], 0.f, 0.f, 0.f);
    }
    __syncthreads();
    const int m = min(kTile, t_end - base);
#pragma unroll 2
    for (int j = 0; j < m; ++j) {
      const float4 A = s[j][0];
      const float4 B = s[j][1];
      const float4 C = s[j][2];
      const float ax = A.x, ay = A.y, az = A.z;
      const float e1x = A.w, e1y = B.x, e1z = B.y;
      const float e2x = B.z, e2y = B.w, e2z = C.x;
#pragma unroll
      for (int i = 0; i < kRays; ++i) {
        // p = d x e2
        const float px = dy[i] * e2z - dz[i] * e2y;
        const float py = dz[i] * e2x - dx[i] * e2z;
        const float pz = dx[i] * e2y - dy[i] * e2x;
        const float det = e1x * px + e1y * py + e1z * pz;
        const bool ok_det = fabsf(det) > eps;
        const float inv = 1.0f / (ok_det ? det : 1.0f);
        const float sx = ox[i] - ax;
        const float sy = oy[i] - ay;
        const float sz = oz[i] - az;
        const float u = (sx * px + sy * py + sz * pz) * inv;
        // q = s x e1
        const float qx = sy * e1z - sz * e1y;
        const float qy = sz * e1x - sx * e1z;
        const float qz = sx * e1y - sy * e1x;
        const float v = (dx[i] * qx + dy[i] * qy + dz[i] * qz) * inv;
        const float t = (e2x * qx + e2y * qy + e2z * qz) * inv;
        if (ok_det && u >= -bary && v >= -bary && u + v <= bary_hi) {
          if (t >= 0.0f && t <= max_dist) tp[i] = fminf(tp[i], t);
          if (t < 0.0f && t >= -max_dist) tn[i] = fminf(tn[i], -t);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const int r = ray0 + k * kThreads;
    if (r < n_rays) {
      if (tp[k] < inf) min_nonneg(t_pos + r, tp[k] + 0.0f);   // -0 -> +0
      if (tn[k] < inf) min_nonneg(t_neg + r, tn[k]);
    }
  }
}

}  // namespace

// The launch geometry comes from the wrapper (ray_blocks x slices
// blocks of kThreads threads, kRays rays a thread, tris_per_slice a
// multiple of the tile); it is refused unless the blocks cover every
// ray and every triangle exactly once.
extern "C" int smk_raycast(const void* orig, const void* dir, const void* tri,
                           int n_rays, int n_tri, int ray_blocks, int slices,
                           int tris_per_slice, float max_dist, float eps,
                           float bary, float bary_hi, void* t_pos,
                           void* t_neg, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  constexpr int64_t kPerBlock = kThreads * kRays;
  const bool rays_ok =
      ray_blocks > 0 &&
      static_cast<int64_t>(ray_blocks) * kPerBlock >= n_rays &&
      static_cast<int64_t>(ray_blocks - 1) * kPerBlock < n_rays;
  const bool tris_ok =
      n_tri <= 0 ||
      (tris_per_slice > 0 && tris_per_slice % kTile == 0 && slices > 0 &&
       slices <= 65535 &&
       static_cast<int64_t>(slices) * tris_per_slice >= n_tri &&
       static_cast<int64_t>(slices - 1) * tris_per_slice < n_tri);
  if (!rays_ok || !tris_ok) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* tp = static_cast<float*>(t_pos);
  float* tn = static_cast<float*>(t_neg);
  fill_inf<<<(n_rays + kThreads - 1) / kThreads, kThreads, 0, s>>>(tp, tn,
                                                                 n_rays);
  if (n_tri > 0) {
    raycast_kernel<<<dim3(ray_blocks, slices), kThreads, 0, s>>>(
        static_cast<const float*>(orig), static_cast<const float*>(dir),
        static_cast<const float*>(tri), n_rays, n_tri, tris_per_slice,
        max_dist, eps, bary, bary_hi, tp, tn);
  }
  return static_cast<int>(cudaGetLastError());
}
