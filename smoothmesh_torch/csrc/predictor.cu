// K3: the fused predictor — centroidal smoothing, the aspect-ratio
// midpoint blend and the step limiter — plus the minimum current edge
// length of each point.
//
// Replaces the TPU kernel TiledEngine._p_body
// (smoothmesh_tpu/ops/tiledstep.py:435, stage P of the tile engine);
// plain version: smoothmesh_torch/ops/smoothing.py predictor_plain
// (centroidal_smoothing -> aspect_ratio_smoothing ->
// constrain_max_step_length; reference src/smoothMesh.C:96-754).
//
// Bound: bytes.  Per point it reads its point_cells and point_points
// rows (+ masks), gathers the cells' centres and the neighbours'
// coordinates and interior flags, and where the share-a-cell test runs
// the point_cells rows of its two closest neighbours; it writes 16
// bytes.  Design: one thread per point, in blocks of 128.  The closest
// three are kept in registers by insertion in slot order with strict
// '<', which is the reference's three successive first-minimum argmins.
// The share-a-cell test intersects the two neighbours' point_cells rows
// (no static bitmask, so no limit on the point degree); it can only
// zero a positive blend fraction, so it runs only where the fraction is
// positive (some 5% of the points of a graded hex mesh), and the result
// is the same bit for bit.  The step limiter keeps the reference's
// discontinuity: it rescales only where |step| > max_step.

#include "common.cuh"

namespace {

using smk::V3;

struct Pick {
  float len;
  V3 vec;
  int id;
};

constexpr int kRegRow = 8;   // slots of a's row held in registers
// Blocks of 128, not smk::kBlock: where a few threads of a warp run the
// share test the others wait, and smaller blocks hand their SM slots on
// sooner (0.165 against 0.179 ms at 256 on an H100, 128^3 inputs).
constexpr int kThreads = 128;

// Do points a and b share a cell?  a's valid cells are held in registers
// kRegRow slots at a time (one pass for rows up to kRegRow wide), and
// b's row is streamed against them.
__device__ bool share_cell(const int* __restrict__ pc,
                           const bool* __restrict__ pcm, int wc, int a,
                           int b) {
  const int* ra = pc + static_cast<int64_t>(a) * wc;
  const int* rb = pc + static_cast<int64_t>(b) * wc;
  const bool* ma = pcm + static_cast<int64_t>(a) * wc;
  const bool* mb = pcm + static_cast<int64_t>(b) * wc;
  for (int a0 = 0; a0 < wc; a0 += kRegRow) {
    int ca[kRegRow];
#pragma unroll
    for (int t = 0; t < kRegRow; ++t) {
      const int w = a0 + t;
      ca[t] = (w < wc && ma[w]) ? __ldg(ra + w) : -1;   // -1: no cell
    }
    for (int j = 0; j < wc; ++j) {
      if (!mb[j]) continue;
      const int cj = __ldg(rb + j);
#pragma unroll
      for (int t = 0; t < kRegRow; ++t) {
        if (ca[t] == cj) return true;
      }
    }
  }
  return false;
}

__global__ void __launch_bounds__(kThreads)
predictor_kernel(const float* __restrict__ points,
                 const float* __restrict__ cell_ctrs,
                 const int* __restrict__ point_cells,
                 const bool* __restrict__ point_cells_mask,
                 const int* __restrict__ point_points,
                 const bool* __restrict__ point_points_mask,
                 const bool* __restrict__ is_internal, int n_points, int wc,
                 int wp, float max_step, float rel_step_frac,
                 int do_boundary, float* __restrict__ proposal,
                 float* __restrict__ curmin_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_points) return;
  const V3 own = smk::load3(points, i);
  const bool internal = is_internal[i];
  const float inf = __int_as_float(0x7f800000);

  // -- centroidal: mean of the surrounding cell centres ----------------
  V3 s{0.f, 0.f, 0.f};
  int cnt = 0;
  if (internal || do_boundary) {
    const int* row = point_cells + static_cast<int64_t>(i) * wc;
    const bool* mrow = point_cells_mask + static_cast<int64_t>(i) * wc;
    for (int w = 0; w < wc; ++w) {
      if (!mrow[w]) continue;
      s = smk::add(s, smk::load3(cell_ctrs, __ldg(row + w)));
      ++cnt;
    }
  }
  V3 cent = own;
  if (cnt > 0) {
    const float c = static_cast<float>(cnt);
    cent = V3{s.x / c, s.y / c, s.z / c};
  }

  // -- closest three eligible neighbours + current minimum edge --------
  Pick p0{inf, V3{0.f, 0.f, 0.f}, -1};
  Pick p1 = p0;
  Pick p2 = p0;
  float cur_min = inf;
  {
    const int* row = point_points + static_cast<int64_t>(i) * wp;
    const bool* mrow = point_points_mask + static_cast<int64_t>(i) * wp;
    for (int w = 0; w < wp; ++w) {
      if (!mrow[w]) continue;
      const int j = __ldg(row + w);
      const V3 d = smk::sub(smk::load3(points, j), own);
      const float len = smk::norm(d);
      cur_min = fminf(cur_min, len);
      // boundary points only consider boundary neighbours
      if (!(internal || !is_internal[j])) continue;
      const Pick cand{len, d, j};
      if (len < p0.len) {
        p2 = p1;
        p1 = p0;
        p0 = cand;
      } else if (len < p1.len) {
        p2 = p1;
        p1 = cand;
      } else if (len < p2.len) {
        p2 = cand;
      }
    }
  }
  const V3 big{smk::kBig, smk::kBig, smk::kBig};
  const bool f0 = p0.len < inf;
  const bool f1 = p1.len < inf;
  const V3 c1 = f0 ? p0.vec : big;
  const V3 c2 = f1 ? p1.vec : big;
  const V3 c3 = (p2.len < inf) ? p2.vec : big;

  // -- aspect-ratio blend ------------------------------------------------
  const float l1 = smk::norm(c1);
  const float l2 = smk::norm(c2);
  const float l3 = smk::norm(c3);
  const float ratio1 = l2 / fmaxf(l1, smk::kVSmall);
  const float ratio2 = l3 / fmaxf(l2, smk::kVSmall);
  float frac_int = fminf(fmaxf((ratio2 - 1.5f) / 1.5f, 0.0f), 1.0f);
  if (!((ratio1 < 1.5f) && (ratio2 > 1.5f))) frac_int = 0.0f;
  const float frac_bnd = fminf(fmaxf(ratio1 - 1.0f, 0.0f), 1.0f);
  float frac = internal ? frac_int : frac_bnd;
  const bool zero1 = (c1.x == 0.0f && c1.y == 0.0f && c1.z == 0.0f) ||
                     (c2.x == 0.0f && c2.y == 0.0f && c2.z == 0.0f);
  if (zero1) frac = 0.0f;
  // the share test only ever zeroes a positive fraction: run it lazily
  if (frac > 0.0f && f0 && f1 &&
      share_cell(point_cells, point_cells_mask, wc, p0.id, p1.id)) {
    frac = 0.0f;
  }

  V3 prop = cent;
  if (frac > 0.0f) {
    const V3 mid = smk::add(own, smk::scale(0.5f, smk::add(c1, c2)));
    prop = smk::add(smk::scale(1.0f - frac, cent), smk::scale(frac, mid));
  }

  // -- step limiter (doGlobalScaling = false) --------------------------
  const V3 step = smk::sub(prop, own);
  const float slen = smk::norm(step);
  float sc = 1.0f;
  if (slen > max_step) sc = max_step / (fmaxf(slen, smk::kVSmall) * rel_step_frac);
  smk::store3(proposal, i, smk::add(own, smk::scale(rel_step_frac * sc, step)));
  curmin_out[i] = cur_min < inf ? cur_min : smk::kBig;
}

}  // namespace

extern "C" int smk_predictor(const void* points, const void* cell_ctrs,
                             const void* point_cells,
                             const void* point_cells_mask,
                             const void* point_points,
                             const void* point_points_mask,
                             const void* is_internal, int n_points, int wc,
                             int wp, float max_step, float rel_step_frac,
                             int do_boundary, void* proposal, void* curmin,
                             void* stream) {
  if (n_points > 0) {
    predictor_kernel<<<(n_points + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(points),
        static_cast<const float*>(cell_ctrs),
        static_cast<const int*>(point_cells),
        static_cast<const bool*>(point_cells_mask),
        static_cast<const int*>(point_points),
        static_cast<const bool*>(point_points_mask),
        static_cast<const bool*>(is_internal), n_points, wc, wp, max_step,
        rel_step_frac, do_boundary, static_cast<float*>(proposal),
        static_cast<float*>(curmin));
  }
  return static_cast<int>(cudaGetLastError());
}
