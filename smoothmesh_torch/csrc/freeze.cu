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
// threshold", with no transcendental in the loop.
//
// Bound: the latency of its scattered gathers (each point reads its ~6
// neighbours' current and proposed positions), then its unfused
// arithmetic: five cosines a wedge, each a dot, a product of two
// clamped norms and an IEEE division (--fmad=false); a point has ~12
// wedges.  Design, as the TPU kernel's slot form: one thread per point
// walks its point_points row once and keeps, per valid neighbour j, P_j
// and N_j (current, proposed) and the clamped norms of own_c->P_j,
// own_p->P_j and own_p->N_j in shared memory (36 bytes a slot, slot x
// record x thread, so that a warp's accesses fall in 32 banks); the
// edge-shortening minima take the same norms unclamped.  The wedge loop
// then reads one int16 word a wedge (prev slot bits 0-4, next slot bits
// 5-9, the point_faces mask bit 15; device.pack_wedges), forms the
// vectors again, and does five dots and five divisions and no square
// root.  The divisions run the compiler's fast-path sequence without
// its per-division branch (smk::div_seq), with one range check per
// point.  Each value is computed from the same operands in the same
// order as the plain version's (a - c, |a - c|, dot / (max(|v1|,
// VSMALL) * max(|v2|, VSMALL))), and each division is the IEEE
// quotient, so the mask is bit-equal to it.

#include "common.cuh"

namespace {

using smk::V3;

constexpr int kThreads = 128;
// A neighbour slot's record: (P, |P - own_c|) and (N, |N - own_p|) as
// two float4, |P - own_p| as one float, the norms clamped; the vectors
// are formed again from P and N where a wedge reads them (the same
// operands, so the same values), which keeps 36 bytes a slot.
constexpr int kRecs = 2;
constexpr int kSlotBytes = 16 * kRecs + 4;
// The range in which smk::div_seq is checked: clamped norms in
// [2^-30, 2^30] (so their products in [2^-60, 2^60]), numerators 0 or
// of magnitude at least 2^-60 (at most 2^60 (1 + 2^-22) by
// Cauchy-Schwarz).
constexpr float kNormLo = 0x1p-30f;
constexpr float kNormHi = 0x1p30f;
constexpr float kNumLo = 0x1p-60f;

// The clamped cosine of the angle between two records' vectors, from
// their clamped norms: dot / (|a| |b|), by '/' (kExact) or by
// smk::div_seq, clearing ok where the numerator leaves its range.
template <bool kExact>
__device__ __forceinline__ float cosine(float4 a, float4 b, bool& ok) {
  const float dc = smk::dot(V3{a.x, a.y, a.z}, V3{b.x, b.y, b.z});
  const float den = a.w * b.w;
  float d;
  if (kExact) {
    d = dc / den;
  } else {
    d = smk::div_seq(dc, den);
    ok &= (fabsf(dc) >= kNumLo) | (dc == 0.0f);
  }
  return fminf(fmaxf(d, -smk::kAcosClamp), smk::kAcosClamp);
}

// A record's vector and clamped norm as one float4.
__device__ __forceinline__ float4 vec(V3 p, V3 own, float n) {
  const V3 v = smk::sub(p, own);
  return make_float4(v.x, v.y, v.z, n);
}

// Max cosines over the point's wedges: current (c) and over the four
// moved/unmoved endpoint combinations (n).  recs: the thread's float4
// records (slot x record x thread); pnorm: its |P - own_p| (slot x
// thread).
template <bool kExact>
__device__ __forceinline__ void wedge_max(const float4* __restrict__ recs,
                                          const float* __restrict__ pnorm,
                                          V3 own_c, V3 own_p,
                                          const int16_t* __restrict__ words,
                                          int wf, float& c, float& n,
                                          bool& ok) {
  auto add = [&](int word) {
    if (word >= 0) return;  // bit 15 clear: no wedge
    const int a = word & 31, b = (word >> 5) & 31;
    const float4 pa = recs[a * kRecs * kThreads];
    const float4 na = recs[(a * kRecs + 1) * kThreads];
    const float4 pb = recs[b * kRecs * kThreads];
    const float4 nb = recs[(b * kRecs + 1) * kThreads];
    const V3 pja{pa.x, pa.y, pa.z}, pjb{pb.x, pb.y, pb.z};
    const V3 nja{na.x, na.y, na.z}, njb{nb.x, nb.y, nb.z};
    c = fmaxf(c, cosine<kExact>(vec(pja, own_c, pa.w),
                                vec(pjb, own_c, pb.w), ok));
    const float4 va = vec(pja, own_p, pnorm[a * kThreads]);
    const float4 vb = vec(pjb, own_p, pnorm[b * kThreads]);
    const float4 wa = vec(nja, own_p, na.w), wb = vec(njb, own_p, nb.w);
    n = fmaxf(n, fmaxf(fmaxf(cosine<kExact>(va, vb, ok),
                             cosine<kExact>(wa, wb, ok)),
                       fmaxf(cosine<kExact>(va, wb, ok),
                             cosine<kExact>(wa, vb, ok))));
  };
  c = -2.0f;
  n = -2.0f;
  if ((wf & 3) == 0) {  // rows of 8-byte multiples: 4 words a load
    const uint2* quads = reinterpret_cast<const uint2*>(words);
    for (int q = 0; q < (wf >> 2); ++q) {
      const uint2 v = __ldg(quads + q);
      add(static_cast<int16_t>(v.x & 0xffffu));
      add(static_cast<int16_t>(v.x >> 16));
      add(static_cast<int16_t>(v.y & 0xffffu));
      add(static_cast<int16_t>(v.y >> 16));
    }
  } else {
    for (int k = 0; k < wf; ++k) add(__ldg(words + k));
  }
}

__global__ void __launch_bounds__(kThreads)
freeze_kernel(const float* __restrict__ points,
              const float* __restrict__ proposed,
              const int* __restrict__ point_points,
              const bool* __restrict__ pp_mask,
              const int16_t* __restrict__ wedge_words,
              const bool* __restrict__ frozen_in, int n_points, int wp,
              int wf, float min_edge, int total_min_freeze,
              float cos_min_angle, int edge_angle_on,
              bool* __restrict__ frozen_out) {
  extern __shared__ float4 shared_recs[];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_points) return;
  float4* recs = shared_recs + threadIdx.x;   // slot x record x thread
  float* pnorm = reinterpret_cast<float*>(shared_recs + wp * kRecs * kThreads)
                 + threadIdx.x;               // slot x thread
  const V3 own_c = smk::load3(points, i);
  const V3 own_p = smk::load3(proposed, i);
  const float inf = __int_as_float(0x7f800000);

  // -- the neighbours: edge-shortening minima and the wedges' records --
  float cur_min = inf;
  float new_min = inf;
  bool ok = true;   // every clamped norm in [kNormLo, kNormHi]
  const int* row = point_points + static_cast<int64_t>(i) * wp;
  const bool* mrow = pp_mask + static_cast<int64_t>(i) * wp;
  for (int w = 0; w < wp; ++w) {
    if (!mrow[w]) continue;
    const int j = row[w];
    const V3 pj = smk::load3(points, j);
    const V3 vc = smk::sub(pj, own_c);
    const V3 vp = smk::sub(pj, own_p);
    const float nc = smk::norm(vc);
    const float np = smk::norm(vp);
    cur_min = fminf(cur_min, nc);
    new_min = fminf(new_min, np);
    if (edge_angle_on) {
      const V3 nj = smk::load3(proposed, j);
      const float m[3] = {fmaxf(nc, smk::kVSmall), fmaxf(np, smk::kVSmall),
                          fmaxf(smk::norm(smk::sub(nj, own_p)),
                                smk::kVSmall)};
      recs[w * kRecs * kThreads] = make_float4(pj.x, pj.y, pj.z, m[0]);
      recs[(w * kRecs + 1) * kThreads] = make_float4(nj.x, nj.y, nj.z, m[2]);
      pnorm[w * kThreads] = m[1];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        ok &= (m[r] >= kNormLo) & (m[r] <= kNormHi);
      }
    }
  }
  bool fr = total_min_freeze
                ? (fminf(cur_min, new_min) < min_edge)
                : ((new_min < min_edge) && (new_min < cur_min));

  // -- edge angles over the point's face wedges ------------------------
  if (edge_angle_on) {
    const int16_t* words = wedge_words + static_cast<int64_t>(i) * wf;
    float max_c, max_n;
    wedge_max<false>(recs, pnorm, own_c, own_p, words, wf, max_c, max_n,
                     ok);
    if (!ok) {
      wedge_max<true>(recs, pnorm, own_c, own_p, words, wf, max_c, max_n,
                      ok);
    }
    fr = fr || ((max_n > cos_min_angle) && (max_n > max_c));
  }
  frozen_out[i] = frozen_in[i] || fr;
}

}  // namespace

extern "C" int smk_freeze_constraints(
    const void* points, const void* proposed, const void* point_points,
    const void* pp_mask, const void* wedge_words, const void* frozen_in,
    int n_points, int wp, int wf, float min_edge, int total_min_freeze,
    float cos_min_angle, int edge_angle_on, void* frozen_out,
    void* stream) {
  if (wp < 0 || wp > 32 || wf < 0) return static_cast<int>(
      cudaErrorInvalidValue);
  if (n_points > 0) {
    const size_t smem =
        edge_angle_on ? size_t{kSlotBytes} * wp * kThreads : 0;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          freeze_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    freeze_kernel<<<(n_points + kThreads - 1) / kThreads, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(points),
        static_cast<const float*>(proposed),
        static_cast<const int*>(point_points),
        static_cast<const bool*>(pp_mask),
        static_cast<const int16_t*>(wedge_words),
        static_cast<const bool*>(frozen_in), n_points, wp, wf, min_edge,
        total_min_freeze, cos_min_angle, edge_angle_on,
        static_cast<bool*>(frozen_out));
  }
  return static_cast<int>(cudaGetLastError());
}
