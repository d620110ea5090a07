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
// Bound: the latency of its gathers of face vertex means (the means,
// 76 MB at 128^3, exceed the L2), then its unfused arithmetic: each
// projection costs a square root and three IEEE divisions
// (--fmad=false).  Design, as the TPU kernel's pvecs: one thread per
// edge; the cell slots come as one int16 word each (f0 bits 0-6, f1
// bits 7-13, the edge_cells mask bit 15; device.pack_edge_cells); a
// first pass over the words marks the face slots that valid cells name,
// each of those faces is projected once into shared memory (a float4 a
// slot, slot x thread, so that a warp's accesses fall in 32 banks), and
// the cell loop reads the projections there.  An internal hex edge
// makes 4 face and 4 cell projections (12 if each cell projected its
// faces) and gathers each face mean once.  The divisions run the
// compiler's fast-path sequence without its per-division branch
// (smk::div_seq), with one range check per edge.  A projection is a pure function of the face mean and
// the edge, and each division is the IEEE quotient, so the result
// equals the plain version's bit for bit.

#include "common.cuh"

namespace {

using smk::V3;

constexpr int kThreads = 128;
// Shared memory a face slot a thread: its projection as a float4.
constexpr int kSlotBytes = 16;
// The range in which smk::div_seq is checked: y and |x| in
// [2^-60, 2^60], or x == 0.
constexpr float kLo = 0x1p-60f;
constexpr float kHi = 0x1p60f;

// x / y by '/' (kExact) or by smk::div_seq, clearing ok where an operand
// leaves its range (the caller then redoes the edge with '/').
template <bool kExact>
__device__ __forceinline__ float divide(float x, float y, bool& ok) {
  if (kExact) return x / y;
  const float ax = fabsf(x);
  ok &= (y >= kLo) & (y <= kHi) & (((ax >= kLo) & (ax <= kHi)) | (x == 0.0f));
  return smk::div_seq(x, y);
}

// Unit vector from ctr to x projected onto the plane through ctr normal
// to the unit vector ev.
template <bool kExact>
__device__ __forceinline__ V3 proj_unit(V3 ctr, V3 ev, V3 x, bool& ok) {
  const float dt = smk::dot(smk::sub(ctr, x), ev);
  const V3 d = smk::sub(smk::add(x, smk::scale(dt, ev)), ctr);
  const float dn = fmaxf(smk::norm(d), smk::kVSmall);
  return V3{divide<kExact>(d.x, dn, ok), divide<kExact>(d.y, dn, ok),
            divide<kExact>(d.z, dn, ok)};
}

__device__ __forceinline__ float clamp_cos(float c) {
  return fminf(fmaxf(c, -smk::kAcosClamp), smk::kAcosClamp);
}

// The face slots of a row that valid cells name: 32 bits, or 128 for
// rows wider than 32.
template <bool kWide>
struct Slots {
  uint32_t bits = 0;
  __device__ __forceinline__ void add(int s) { bits |= 1u << s; }
  __device__ __forceinline__ bool has(int s) const {
    return (bits >> s) & 1u;
  }
};

template <>
struct Slots<true> {
  uint64_t lo = 0, hi = 0;
  __device__ __forceinline__ void add(int s) {
    if (s < 64) {
      lo |= 1ull << s;
    } else {
      hi |= 1ull << (s - 64);
    }
  }
  __device__ __forceinline__ bool has(int s) const {
    return ((s < 64 ? lo : hi) >> (s & 63)) & 1ull;
  }
};

// The cell's two face slots from its word, or false for no valid cell.
__device__ __forceinline__ bool cell_slots(int word, int wf, int& s0,
                                           int& s1) {
  s0 = word & 127;
  s1 = (word >> 7) & 127;
  return word < 0 && s0 < wf && s1 < wf;  // bit 15: a valid cell
}

// One edge's [u_min, u_max]; with kExact = false, ok is cleared where a
// division left div_seq's range.
template <bool kWide, bool kExact>
__device__ __forceinline__ float2 edge_minmax(
    const float* __restrict__ points, const float* __restrict__ means,
    const float* __restrict__ cell_ctrs, const int* __restrict__ ends,
    const int* __restrict__ frow, const int* __restrict__ crow,
    const int16_t* __restrict__ words, int wf, int wc, float4* faces,
    bool& ok) {
  const V3 e0 = smk::load3(points, __ldg(ends));
  const V3 e1 = smk::load3(points, __ldg(ends + 1));
  const V3 ctr = smk::scale(0.5f, smk::add(e0, e1));
  V3 ev = smk::sub(e1, e0);
  const float en = fmaxf(smk::norm(ev), smk::kVSmall);
  ev = V3{divide<kExact>(ev.x, en, ok), divide<kExact>(ev.y, en, ok),
          divide<kExact>(ev.z, en, ok)};

  Slots<kWide> named;
  int s0, s1;
  for (int u = 0; u < wc; ++u) {
    if (!cell_slots(__ldg(words + u), wf, s0, s1)) continue;
    named.add(s0);
    named.add(s1);
  }
  // each named face projected once
  for (int s = 0; s < wf; ++s) {
    if (!named.has(s)) continue;
    const V3 v =
        proj_unit<kExact>(ctr, ev, smk::load3(means, __ldg(frow + s)), ok);
    faces[s * kThreads] = make_float4(v.x, v.y, v.z, 0.0f);
  }
  float u_min = 4.0f;
  float u_max = 0.0f;
  for (int u = 0; u < wc; ++u) {
    if (!cell_slots(__ldg(words + u), wf, s0, s1)) continue;
    const float4 f0 = faces[s0 * kThreads];
    const float4 f1 = faces[s1 * kThreads];
    const V3 p0{f0.x, f0.y, f0.z};
    const V3 p1{f1.x, f1.y, f1.z};
    const V3 cv = proj_unit<kExact>(
        ctr, ev, smk::load3(cell_ctrs, __ldg(crow + u)), ok);
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
  return make_float2(u_min, u_max);
}

template <bool kWide>
__global__ void __launch_bounds__(kThreads)
face_angles_kernel(const float* __restrict__ points,
                   const float* __restrict__ means,
                   const float* __restrict__ cell_ctrs,
                   const int* __restrict__ edges,
                   const int* __restrict__ edge_faces,
                   const int* __restrict__ edge_cells,
                   const int16_t* __restrict__ cell_words, int n_edges,
                   int wf, int wc, float* __restrict__ out) {
  extern __shared__ float4 shared_faces[];
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n_edges) return;
  float4* faces = shared_faces + threadIdx.x;   // slot x thread
  const int* ends = edges + 2 * static_cast<int64_t>(e);
  const int* frow = edge_faces + static_cast<int64_t>(e) * wf;
  const int* crow = edge_cells + static_cast<int64_t>(e) * wc;
  const int16_t* words = cell_words + static_cast<int64_t>(e) * wc;
  bool ok = true;
  float2 u = edge_minmax<kWide, false>(points, means, cell_ctrs, ends, frow,
                                       crow, words, wf, wc, faces, ok);
  if (!ok) {
    u = edge_minmax<kWide, true>(points, means, cell_ctrs, ends, frow, crow,
                                 words, wf, wc, faces, ok);
  }
  reinterpret_cast<float2*>(out)[e] = u;
}

}  // namespace

extern "C" int smk_face_angles(const void* points, const void* means,
                               const void* cell_ctrs, const void* edges,
                               const void* edge_faces, const void* edge_cells,
                               const void* cell_words, int n_edges, int wf,
                               int wc, void* out, void* stream) {
  if (wf < 0 || wf >= 128 || wc < 0) return static_cast<int>(
      cudaErrorInvalidValue);
  if (n_edges > 0) {
    const size_t smem = size_t{kSlotBytes} * wf * kThreads;
    const auto kernel =
        wf <= 32 ? face_angles_kernel<false> : face_angles_kernel<true>;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<(n_edges + kThreads - 1) / kThreads, kThreads, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(points), static_cast<const float*>(means),
        static_cast<const float*>(cell_ctrs), static_cast<const int*>(edges),
        static_cast<const int*>(edge_faces),
        static_cast<const int*>(edge_cells),
        static_cast<const int16_t*>(cell_words), n_edges, wf, wc,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
