// K4: the edge-shortening and edge-angle freezes, ORed into the
// incoming freeze mask.
//
// Replaces the TPU kernel TiledEngine._s_body
// (smoothmesh_tpu/ops/tiledstep.py:724, stage S of the tile engine);
// plain version: smoothmesh_torch/ops/constraints.py
// freeze_constraints_plain (restrictEdgeShortening +
// restrictMinEdgeAngleDecrease, reference src/smoothMesh.C:602-652,
// :766-930).
//
// Angles are compared as clamped cosines in reversed order: acos is
// strictly decreasing, so "min angle < threshold" is "max cos > cos
// threshold", with no transcendental in the loop.  The wedge tables
// hold point ids (the (prev, next) perimeter neighbours of each
// (point, face) incidence); every gather is guarded by the row mask.
//
// Bound: bytes.  Per point it reads its point_points row, its wedge rows
// (2 ids + a mask per incident face) and gathers the current and
// proposed coordinates of those neighbours (mostly L2 hits in RCB
// order); it writes one byte.  Design: one thread per point, all
// reductions (min edge lengths, max wedge cosines) in registers.

#include "common.cuh"

namespace {

using smk::V3;

__device__ __forceinline__ float cos_angle(V3 c, V3 p1, V3 p2) {
  const V3 v1 = smk::sub(p1, c);
  const V3 v2 = smk::sub(p2, c);
  const float n1 = smk::norm(v1);
  const float n2 = smk::norm(v2);
  const float d = smk::dot(v1, v2) /
                  (fmaxf(n1, smk::kVSmall) * fmaxf(n2, smk::kVSmall));
  return fminf(fmaxf(d, -smk::kAcosClamp), smk::kAcosClamp);
}

__global__ void __launch_bounds__(smk::kBlock)
freeze_kernel(const float* __restrict__ points,
              const float* __restrict__ proposed,
              const int* __restrict__ point_points,
              const bool* __restrict__ pp_mask,
              const bool* __restrict__ pf_mask,
              const int* __restrict__ wedge_prev,
              const int* __restrict__ wedge_next,
              const bool* __restrict__ frozen_in, int n_points, int wp,
              int wf, float min_edge, int total_min_freeze,
              float cos_min_angle, int edge_angle_on,
              bool* __restrict__ frozen_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_points) return;
  const V3 own_c = smk::load3(points, i);
  const V3 own_p = smk::load3(proposed, i);
  const float inf = __int_as_float(0x7f800000);

  // -- edge shortening -------------------------------------------------
  float cur_min = inf;
  float new_min = inf;
  {
    const int* row = point_points + static_cast<int64_t>(i) * wp;
    const bool* mrow = pp_mask + static_cast<int64_t>(i) * wp;
    for (int w = 0; w < wp; ++w) {
      if (!mrow[w]) continue;
      const V3 nb = smk::load3(points, __ldg(row + w));
      cur_min = fminf(cur_min, smk::norm(smk::sub(nb, own_c)));
      new_min = fminf(new_min, smk::norm(smk::sub(nb, own_p)));
    }
  }
  bool fr = total_min_freeze
                ? (fminf(cur_min, new_min) < min_edge)
                : ((new_min < min_edge) && (new_min < cur_min));

  // -- edge angles over the point's face wedges ------------------------
  if (edge_angle_on) {
    float max_c = -2.0f;
    float max_n = -2.0f;
    const int64_t base = static_cast<int64_t>(i) * wf;
    for (int k = 0; k < wf; ++k) {
      if (!pf_mask[base + k]) continue;
      const int a = __ldg(wedge_prev + base + k);
      const int b = __ldg(wedge_next + base + k);
      const V3 cp1 = smk::load3(points, a);
      const V3 cp2 = smk::load3(points, b);
      const V3 np1 = smk::load3(proposed, a);
      const V3 np2 = smk::load3(proposed, b);
      const float cos_c = cos_angle(own_c, cp1, cp2);
      const float cos_n =
          fmaxf(fmaxf(cos_angle(own_p, cp1, cp2), cos_angle(own_p, np1, np2)),
                fmaxf(cos_angle(own_p, cp1, np2), cos_angle(own_p, np1, cp2)));
      max_c = fmaxf(max_c, cos_c);
      max_n = fmaxf(max_n, cos_n);
    }
    fr = fr || ((max_n > cos_min_angle) && (max_n > max_c));
  }
  frozen_out[i] = frozen_in[i] || fr;
}

}  // namespace

extern "C" int smk_freeze_constraints(
    const void* points, const void* proposed, const void* point_points,
    const void* pp_mask, const void* pf_mask, const void* wedge_prev,
    const void* wedge_next, const void* frozen_in, int n_points, int wp,
    int wf, float min_edge, int total_min_freeze, float cos_min_angle,
    int edge_angle_on, void* frozen_out, void* stream) {
  if (n_points > 0) {
    freeze_kernel<<<smk::grid_for(n_points), smk::kBlock, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(points),
        static_cast<const float*>(proposed),
        static_cast<const int*>(point_points),
        static_cast<const bool*>(pp_mask), static_cast<const bool*>(pf_mask),
        static_cast<const int*>(wedge_prev),
        static_cast<const int*>(wedge_next),
        static_cast<const bool*>(frozen_in), n_points, wp, wf, min_edge,
        total_min_freeze, cos_min_angle, edge_angle_on,
        static_cast<bool*>(frozen_out));
  }
  return static_cast<int>(cudaGetLastError());
}
