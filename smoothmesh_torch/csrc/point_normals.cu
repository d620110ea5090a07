// K9: the boundary point normals' update, one pass over the points.
//
// Replaces no TPU kernel: the JAX package computes the normals in XLA
// (smoothmesh_tpu/layers.py:216 accumulate_point_normals); plain
// version: smoothmesh_torch/layers.py accumulate_point_normals_plain
// (calculateBoundaryPointNormals, reference oBB.C:141-233, run each
// iteration at src/smoothMesh.C:2266 on the previous field).
//
// Bound: memory traffic.  Every point reads its previous normal and
// is_internal_point and writes its normal and is_sharp (26 bytes); only
// a boundary point can have a real-boundary face, so only it reads its
// point_faces row and mask, the faces' flags and the selected faces'
// area vectors.  The plain version makes several full-size passes
// instead (the unit vectors of every face, an (N, W, 3) gather and its
// mask, a slot sum and about ten elementwise passes over N).
//
// Design: one thread per point, no atomics, so the result does not
// depend on scheduling.  An internal point skips the face loop: every
// face of its row is internal (is_internal_point is false on every
// point of a boundary face), so its sum is +0 and its count 0, as the
// plain version's.  A boundary point walks its row in slot order, adds
// the unit area vector a / max(|a|, 1e-30) of each selected face (mask
// on and the face on a real patch) to a sum that starts at +0, and
// counts them; the unselected slots, which the plain version adds as
// +0, leave a sum that is never -0 unchanged.  The rest follows the
// plain version's order: prev + (-sum), its norm in (x*x + y*y) + z*z
// order, is_sharp = (count >= 1) & (mag < 0.1), zero where sharp,
// divided by max(mag, 1e-30) where mag > 0 and not sharp.  Every
// division is IEEE's ('/', --fmad=false), so the result is bit-equal to
// the plain version's.

#include "common.cuh"

namespace {

using smk::V3;

// torch's clamp_min: max(x, lo), a NaN kept
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

__device__ __forceinline__ V3 quot3(V3 a, float d) {
  return V3{a.x / d, a.y / d, a.z / d};
}

__global__ void __launch_bounds__(smk::kBlock)
point_normals_kernel(const float* __restrict__ prev,
                     const float* __restrict__ face_areas,
                     const int* __restrict__ point_faces,
                     const bool* __restrict__ pf_mask,
                     const bool* __restrict__ face_real,
                     const bool* __restrict__ internal, int n_points,
                     int wf, float* __restrict__ normals,
                     bool* __restrict__ is_sharp) {
  const int i = blockIdx.x * smk::kBlock + threadIdx.x;
  if (i >= n_points) return;
  V3 sum{0.0f, 0.0f, 0.0f};
  int n_faces = 0;
  if (!internal[i]) {
    const int* row = point_faces + static_cast<int64_t>(i) * wf;
    const bool* mrow = pf_mask + static_cast<int64_t>(i) * wf;
    for (int w = 0; w < wf; ++w) {
      if (!mrow[w]) continue;
      const int f = __ldg(row + w);
      if (!face_real[f]) continue;
      const V3 a = smk::load3(face_areas, f);
      const float m = clamp_min(smk::norm(a), smk::kVSmall);
      sum = smk::add(sum, quot3(a, m));
      ++n_faces;
    }
  }
  const V3 p = smk::load3(prev, i);
  V3 v = smk::add(p, V3{-sum.x, -sum.y, -sum.z});
  const float mag = smk::norm(v);
  const bool sharp = (n_faces >= 1) && (mag < 0.1f);
  if (sharp) {
    v = V3{0.0f, 0.0f, 0.0f};
  } else if (mag > 0.0f) {
    v = quot3(v, clamp_min(mag, smk::kVSmall));
  }
  smk::store3(normals, i, v);
  is_sharp[i] = sharp;
}

}  // namespace

extern "C" int smk_point_normals(const void* prev, const void* face_areas,
                                 const void* point_faces,
                                 const void* pf_mask, const void* face_real,
                                 const void* internal, int n_points, int wf,
                                 void* normals, void* is_sharp,
                                 void* stream) {
  if (wf < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_points > 0) {
    point_normals_kernel<<<(n_points + smk::kBlock - 1) / smk::kBlock,
                           smk::kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(prev),
        static_cast<const float*>(face_areas),
        static_cast<const int*>(point_faces),
        static_cast<const bool*>(pf_mask),
        static_cast<const bool*>(face_real),
        static_cast<const bool*>(internal), n_points, wf,
        static_cast<float*>(normals), static_cast<bool*>(is_sharp));
  }
  return static_cast<int>(cudaGetLastError());
}
