// K2: cell centres and volumes.
//
// Replaces the TPU kernel TiledEngine._c_body
// (smoothmesh_tpu/ops/tiledstep.py:391, stage C of the tile engine);
// plain version: smoothmesh_torch/geometry.py cell_centres_vols_plain
// (OpenFOAM primitiveMesh::makeCellCentresAndVols: face pyramids about
// the mean of the face centres, signed +1 where the cell owns the face;
// the mean where |vol| <= VSMALL).
//
// Bound: bytes.  Per cell it reads one row of cell-face words (int32:
// the face id, bit 30 set where the cell is the face's neighbour, -1 on
// a padded slot; device.pack_cell_faces, the TPU kernel's stage-C meta
// word at 32 bits) and gathers each face's centre and area vector (24
// bytes a face, each face read by its two cells, mostly from L2 thanks
// to the face order that follows the RCB point order); it writes 16
// bytes.  The word carries the pyramid's sign, so no owner is gathered.
// On an H100 these gathers set its pace.  Design: one thread per cell.
// Rows of exactly kRowW = 6 words (a mesh whose cells have at most six
// faces, at least one cell six) are read as three 8-byte loads, each
// face's centre into registers for the centre estimate, its area
// vector in the pyramid loop, so each face is gathered once.  Other
// widths take a general path that walks the row twice.  The four
// divisions run the compiler's fast-path sequence (smk::div3 and div1,
// '/' outside their checked range, which a negative volume leaves).
// The sums run in slot order from +0 and every value takes the plain
// version's operands in its order, so the results are bit-equal to it.

#include "common.cuh"

namespace {

using smk::V3;

constexpr int kThreads = 256;
// The register path's row: exactly 6 faces, three int2.
constexpr int kRowW = 6;
constexpr int kFaceBits = 0x3fffffff;   // bits 0-29: the face id
constexpr int kNegBit = 1 << 30;        // the cell is the neighbour

// One face pyramid about the centre estimate ce into the sums.
__device__ __forceinline__ void add_pyramid(V3 fc, V3 fa, int word, V3 ce,
                                            float& vol3, V3& num) {
  const float sign = (word & kNegBit) ? -1.0f : 1.0f;
  const float pyr3 = sign * smk::dot(fa, smk::sub(fc, ce));
  const V3 pc = smk::add(smk::scale(0.75f, fc), smk::scale(0.25f, ce));
  vol3 = vol3 + pyr3;
  num = smk::add(num, smk::scale(pyr3, pc));
}

template <bool kRow>
__global__ void __launch_bounds__(kThreads)
cell_centres_kernel(const float* __restrict__ face_centres,
                    const float* __restrict__ face_areas,
                    const int* __restrict__ words, int n_cells, int width,
                    float* __restrict__ centres, float* __restrict__ vols) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= n_cells) return;
  const int* row = words + static_cast<int64_t>(c) * width;
  V3 s{0.f, 0.f, 0.f};
  int nf = 0;
  float vol3 = 0.f;
  V3 num{0.f, 0.f, 0.f};
  V3 ce;
  if constexpr (kRow) {
    static_assert(kRowW % 2 == 0, "a row is whole int2s");
    int wd[kRowW];
    const int2* r2 = reinterpret_cast<const int2*>(row);
#pragma unroll
    for (int q = 0; q < kRowW / 2; ++q) {
      const int2 v = __ldg(r2 + q);
      wd[2 * q] = v.x;
      wd[2 * q + 1] = v.y;
    }
    V3 fc[kRowW];
#pragma unroll
    for (int w = 0; w < kRowW; ++w) {
      if (wd[w] >= 0) {
        fc[w] = smk::load3(face_centres, wd[w] & kFaceBits);
        s = smk::add(s, fc[w]);
        ++nf;
      }
    }
    ce = smk::div3(s, fmaxf(static_cast<float>(nf), 1.0f));
#pragma unroll
    for (int w = 0; w < kRowW; ++w) {
      if (wd[w] >= 0) {
        add_pyramid(fc[w], smk::load3(face_areas, wd[w] & kFaceBits), wd[w],
                    ce, vol3, num);
      }
    }
  } else {
    for (int w = 0; w < width; ++w) {
      const int wd = __ldg(row + w);
      if (wd < 0) continue;
      s = smk::add(s, smk::load3(face_centres, wd & kFaceBits));
      ++nf;
    }
    ce = smk::div3(s, fmaxf(static_cast<float>(nf), 1.0f));
    for (int w = 0; w < width; ++w) {
      const int wd = __ldg(row + w);
      if (wd < 0) continue;
      const int f = wd & kFaceBits;
      add_pyramid(smk::load3(face_centres, f), smk::load3(face_areas, f), wd,
                  ce, vol3, num);
    }
  }
  const bool good = fabsf(vol3) > smk::kVSmall;
  smk::store3(centres, c, good ? smk::div3(num, vol3) : ce);
  vols[c] = smk::div1(vol3, 3.0f);
}

template <bool kRow>
void launch(const void* face_centres, const void* face_areas,
            const void* words, int n_cells, int width, void* centres,
            void* vols, cudaStream_t stream) {
  cell_centres_kernel<kRow><<<(n_cells + kThreads - 1) / kThreads, kThreads,
                              0, stream>>>(
      static_cast<const float*>(face_centres),
      static_cast<const float*>(face_areas),
      static_cast<const int*>(words), n_cells, width,
      static_cast<float*>(centres), static_cast<float*>(vols));
}

}  // namespace

// Rows exactly kRowW wide on an 8-byte-aligned table take the register
// path, others the general one.
extern "C" int smk_cell_centres_vols(const void* face_centres,
                                     const void* face_areas,
                                     const void* words, int n_cells,
                                     int width, void* centres, void* vols,
                                     void* stream) {
  if (n_cells > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (width == kRowW && (reinterpret_cast<uintptr_t>(words) & 7) == 0) {
      launch<true>(face_centres, face_areas, words, n_cells, width, centres,
                   vols, s);
    } else {
      launch<false>(face_centres, face_areas, words, n_cells, width, centres,
                    vols, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
