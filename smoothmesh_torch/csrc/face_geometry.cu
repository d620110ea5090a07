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
// bytes; the arithmetic is ~40 flops per vertex.  Design: one thread
// per face, two passes over the row (the mean first, then the fan),
// the second pass re-reading the same points from L1.  The next
// vertex wraps at face_npoints - 1.

#include "common.cuh"

namespace {

using smk::V3;

__global__ void __launch_bounds__(smk::kBlock)
face_geometry_kernel(const float* __restrict__ points,
                     const int* __restrict__ face_points,
                     const int* __restrict__ face_npoints, int n_faces,
                     int width, float* __restrict__ centres,
                     float* __restrict__ areas, float* __restrict__ means) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= n_faces) return;
  const int* row = face_points + static_cast<int64_t>(f) * width;
  const int n = min(__ldg(face_npoints + f), width);

  V3 s{0.f, 0.f, 0.f};
  for (int w = 0; w < n; ++w) s = smk::add(s, smk::load3(points, __ldg(row + w)));
  const float cnt = static_cast<float>(n);
  const V3 vm{s.x / cnt, s.y / cnt, s.z / cnt};

  V3 sum_n{0.f, 0.f, 0.f};
  V3 sum_ac{0.f, 0.f, 0.f};
  float sum_a = 0.f;
  const V3 p0 = n > 0 ? smk::load3(points, __ldg(row)) : vm;
  V3 p = p0;
  for (int w = 0; w < n; ++w) {
    const V3 nxt = (w + 1 < n) ? smk::load3(points, __ldg(row + w + 1)) : p0;
    // c = p + nxt + vm ; n_vec = cross(nxt - p, vm - p)
    const V3 c = smk::add(smk::add(p, nxt), vm);
    const V3 a = smk::sub(nxt, p);
    const V3 b = smk::sub(vm, p);
    const V3 nv{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
                a.x * b.y - a.y * b.x};
    const float area = smk::norm(nv);
    sum_n = smk::add(sum_n, nv);
    sum_a = sum_a + area;
    sum_ac = smk::add(sum_ac, V3{area * c.x, area * c.y, area * c.z});
    p = nxt;
  }

  const bool good = sum_a > smk::kRootVSmall;
  const float den = 3.0f * fmaxf(sum_a, smk::kVSmall);
  const V3 fc = good ? V3{sum_ac.x / den, sum_ac.y / den, sum_ac.z / den} : vm;
  const V3 fa = good ? smk::scale(0.5f, sum_n) : V3{0.f, 0.f, 0.f};
  smk::store3(centres, f, fc);
  smk::store3(areas, f, fa);
  smk::store3(means, f, vm);
}

}  // namespace

extern "C" int smk_face_geometry(const void* points, const void* face_points,
                                 const void* face_npoints, int n_faces,
                                 int width, void* centres, void* areas,
                                 void* means, void* stream) {
  if (n_faces > 0) {
    face_geometry_kernel<<<smk::grid_for(n_faces), smk::kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(points),
        static_cast<const int*>(face_points),
        static_cast<const int*>(face_npoints), n_faces, width,
        static_cast<float*>(centres), static_cast<float*>(areas),
        static_cast<float*>(means));
  }
  return static_cast<int>(cudaGetLastError());
}
