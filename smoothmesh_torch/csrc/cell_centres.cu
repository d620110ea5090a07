// K2: cell centres and volumes.
//
// Replaces the TPU kernel TiledEngine._c_body
// (smoothmesh_tpu/ops/tiledstep.py:391, stage C of the tile engine);
// plain version: smoothmesh_torch/geometry.py cell_centres_vols_plain
// (OpenFOAM primitiveMesh::makeCellCentresAndVols: face pyramids about
// the mean of the face centres, signed +1 where the cell owns the face;
// the mean where |vol| <= VSMALL).
//
// Bound: bytes.  Per cell it reads one cell_faces row + mask and gathers
// each face's centre, area vector and owner (28 bytes a face, each face
// read by its two cells, mostly from L2 thanks to the face order that
// follows the RCB point order); it writes 16 bytes.  Design: one thread
// per cell, two passes over the row (the centre estimate, then the
// pyramids), the second pass re-reading the same faces from L1.

#include "common.cuh"

namespace {

using smk::V3;

__global__ void __launch_bounds__(smk::kBlock)
cell_centres_kernel(const float* __restrict__ face_centres,
                    const float* __restrict__ face_areas,
                    const int* __restrict__ owner,
                    const int* __restrict__ cell_faces,
                    const bool* __restrict__ cell_faces_mask, int n_cells,
                    int width, float* __restrict__ centres,
                    float* __restrict__ vols) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_cells) return;
  const int64_t base = static_cast<int64_t>(c) * width;
  const int* row = cell_faces + base;
  const bool* mrow = cell_faces_mask + base;

  V3 s{0.f, 0.f, 0.f};
  int nf = 0;
  for (int w = 0; w < width; ++w) {
    if (!mrow[w]) continue;
    s = smk::add(s, smk::load3(face_centres, __ldg(row + w)));
    ++nf;
  }
  const float cnt = fmaxf(static_cast<float>(nf), 1.0f);
  const V3 ce{s.x / cnt, s.y / cnt, s.z / cnt};

  float vol3 = 0.f;
  V3 num{0.f, 0.f, 0.f};
  for (int w = 0; w < width; ++w) {
    if (!mrow[w]) continue;
    const int f = __ldg(row + w);
    const V3 fc = smk::load3(face_centres, f);
    const V3 fa = smk::load3(face_areas, f);
    const float sign = (__ldg(owner + f) == c) ? 1.0f : -1.0f;
    const float pyr3 = sign * smk::dot(fa, smk::sub(fc, ce));
    const V3 pc = smk::add(smk::scale(0.75f, fc), smk::scale(0.25f, ce));
    vol3 = vol3 + pyr3;
    num = smk::add(num, smk::scale(pyr3, pc));
  }

  const bool good = fabsf(vol3) > smk::kVSmall;
  const V3 cc = good ? V3{num.x / vol3, num.y / vol3, num.z / vol3} : ce;
  smk::store3(centres, c, cc);
  vols[c] = vol3 / 3.0f;
}

}  // namespace

extern "C" int smk_cell_centres_vols(const void* face_centres,
                                     const void* face_areas, const void* owner,
                                     const void* cell_faces,
                                     const void* cell_faces_mask, int n_cells,
                                     int width, void* centres, void* vols,
                                     void* stream) {
  if (n_cells > 0) {
    cell_centres_kernel<<<smk::grid_for(n_cells), smk::kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(face_centres),
        static_cast<const float*>(face_areas),
        static_cast<const int*>(owner), static_cast<const int*>(cell_faces),
        static_cast<const bool*>(cell_faces_mask), n_cells, width,
        static_cast<float*>(centres), static_cast<float*>(vols));
  }
  return static_cast<int>(cudaGetLastError());
}
