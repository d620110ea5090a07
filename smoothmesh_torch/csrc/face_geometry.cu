// K1: face centres, area vectors and vertex means.
//
// Replaces the TPU kernel TiledEngine._f_body
// (smoothmesh_tpu/ops/tiledstep.py:323, stage F of the tile engine);
// plain version: smoothmesh_torch/geometry.py face_centres_areas_plain
// (OpenFOAM primitiveMesh face geometry: a triangle fan about the
// vertex mean, area-weighted sub-triangle centroids; the vertex mean
// where the area is <= ROOT_VSMALL).
//
// Bound: bytes.  Per face it reads one face_points row and the count,
// gathers the face's points (12 bytes each, mostly L2 hits: RCB point
// order keeps a face's points near its neighbours'), and writes 36
// bytes, 60% of its traffic; the arithmetic is ~40 flops per vertex.
// On an H100 the point gathers, not the stores, set its pace (every
// thread reading one row took half its time off).  Design: one thread
// per face.  Rows of exactly kRowW = 4 (a mesh whose widest face is a
// quad) are read with one 16-byte load, and each point is gathered once
// into registers; the vertex mean and the fan are taken from there.
// Other widths take a general path that walks the row twice.  The
// outputs are stored directly: staging them through shared memory for
// 16-byte stores measured slower.  The six divisions run the compiler's
// fast-path sequence (smk::div3: one range check for three quotients,
// '/' outside it).  The sums run in slot order from +0 and every value
// takes the plain version's operands in its order, so the results are
// bit-equal to it.  The next vertex wraps at face_npoints - 1.

#include "common.cuh"

namespace {

using smk::V3;

constexpr int kThreads = 256;
// The register path's row: exactly 4 points, one int4.
constexpr int kRowW = 4;

// One fan triangle (p, nxt, vm) into the sums: c = p + nxt + vm,
// n = (nxt - p) x (vm - p), area |n|.
__device__ __forceinline__ void add_tri(V3 p, V3 nxt, V3 vm, V3& sum_n,
                                        float& sum_a, V3& sum_ac) {
  const V3 c = smk::add(smk::add(p, nxt), vm);
  const V3 a = smk::sub(nxt, p);
  const V3 b = smk::sub(vm, p);
  const V3 nv{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x};
  const float area = smk::norm(nv);
  sum_n = smk::add(sum_n, nv);
  sum_a = sum_a + area;
  sum_ac = smk::add(sum_ac, smk::scale(area, c));
}

// The centre and area vector from the fan's sums.
__device__ __forceinline__ void finish(V3 sum_n, float sum_a, V3 sum_ac,
                                       V3 vm, V3& fc, V3& fa) {
  const bool good = sum_a > smk::kRootVSmall;
  const float den = 3.0f * fmaxf(sum_a, smk::kVSmall);
  fc = good ? smk::div3(sum_ac, den) : vm;
  fa = good ? smk::scale(0.5f, sum_n) : V3{0.f, 0.f, 0.f};
}

// A face whose n <= kW points are held in registers.
template <int kW>
__device__ __forceinline__ void face_in_registers(const V3 (&p)[kW], int n,
                                                  V3& fc, V3& fa, V3& vm) {
  V3 s{0.f, 0.f, 0.f};
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    if (w < n) s = smk::add(s, p[w]);
  }
  vm = smk::div3(s, static_cast<float>(n));
  V3 sum_n{0.f, 0.f, 0.f};
  V3 sum_ac{0.f, 0.f, 0.f};
  float sum_a = 0.f;
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    if (w < n) {
      const V3 nxt = (w + 1 < n) ? p[(w + 1) % kW] : p[0];
      add_tri(p[w], nxt, vm, sum_n, sum_a, sum_ac);
    }
  }
  finish(sum_n, sum_a, sum_ac, vm, fc, fa);
}

// A face of any width: the row walked twice, points re-read from L1.
__device__ __forceinline__ void face_general(const float* __restrict__ points,
                                             const int* __restrict__ row,
                                             int n, V3& fc, V3& fa, V3& vm) {
  V3 s{0.f, 0.f, 0.f};
  for (int w = 0; w < n; ++w) {
    s = smk::add(s, smk::load3(points, __ldg(row + w)));
  }
  vm = smk::div3(s, static_cast<float>(n));
  V3 sum_n{0.f, 0.f, 0.f};
  V3 sum_ac{0.f, 0.f, 0.f};
  float sum_a = 0.f;
  const V3 p0 = n > 0 ? smk::load3(points, __ldg(row)) : vm;
  V3 p = p0;
  for (int w = 0; w < n; ++w) {
    const V3 nxt = (w + 1 < n) ? smk::load3(points, __ldg(row + w + 1)) : p0;
    add_tri(p, nxt, vm, sum_n, sum_a, sum_ac);
    p = nxt;
  }
  finish(sum_n, sum_a, sum_ac, vm, fc, fa);
}

template <bool kRow>
__global__ void __launch_bounds__(kThreads)
face_geometry_kernel(const float* __restrict__ points,
                     const int* __restrict__ face_points,
                     const int* __restrict__ face_npoints, int n_faces,
                     int width, float* __restrict__ centres,
                     float* __restrict__ areas, float* __restrict__ means) {
  const int f = blockIdx.x * kThreads + threadIdx.x;
  if (f >= n_faces) return;
  const int* row = face_points + static_cast<int64_t>(f) * width;
  const int n = min(__ldg(face_npoints + f), width);
  V3 fc, fa, vm;
  if constexpr (kRow) {
    static_assert(kRowW == 4, "a row is one int4");
    const int4 r = __ldg(reinterpret_cast<const int4*>(row));
    const int idx[kRowW] = {r.x, r.y, r.z, r.w};
    V3 p[kRowW];
#pragma unroll
    for (int w = 0; w < kRowW; ++w) {
      p[w] = w < n ? smk::load3(points, idx[w]) : V3{0.f, 0.f, 0.f};
    }
    face_in_registers<kRowW>(p, n, fc, fa, vm);
  } else {
    face_general(points, row, n, fc, fa, vm);
  }
  smk::store3(centres, f, fc);
  smk::store3(areas, f, fa);
  smk::store3(means, f, vm);
}

template <bool kRow>
void launch(const void* points, const void* face_points,
            const void* face_npoints, int n_faces, int width, void* centres,
            void* areas, void* means, cudaStream_t stream) {
  face_geometry_kernel<kRow><<<(n_faces + kThreads - 1) / kThreads,
                               kThreads, 0, stream>>>(
      static_cast<const float*>(points),
      static_cast<const int*>(face_points),
      static_cast<const int*>(face_npoints), n_faces, width,
      static_cast<float*>(centres), static_cast<float*>(areas),
      static_cast<float*>(means));
}

}  // namespace

// Rows exactly kRowW wide on a 16-byte-aligned table take the register
// path, others the general one.
extern "C" int smk_face_geometry(const void* points, const void* face_points,
                                 const void* face_npoints, int n_faces,
                                 int width, void* centres, void* areas,
                                 void* means, void* stream) {
  if (n_faces > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (width == kRowW &&
        (reinterpret_cast<uintptr_t>(face_points) & 15) == 0) {
      launch<true>(points, face_points, face_npoints, n_faces, width,
                   centres, areas, means, s);
    } else {
      launch<false>(points, face_points, face_npoints, n_faces, width,
                    centres, areas, means, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
