// K7: the table gather out[i, w, :] = x[table[i, w], :] over a padded
// table, with masked slots written as 0.
//
// Replaces the TPU kernel tiled_gather (smoothmesh_tpu/ops/tiled.py:551,
// launched through stage_call, pallas_call at :530): the select engine's
// standalone gather, which stages span windows and ghost rows of x in
// VMEM and picks each slot with one-hot MXU selects because Pallas on
// the TPU cannot gather inside VMEM.  Hopper gathers from device memory
// natively, so none of that machinery is ported: the kernel reads the
// padded table directly.  Plain version: smoothmesh_torch/ops/gather.py
// table_gather_plain.  The JAX function leaves masked slots arbitrary;
// here and in the plain version they are 0, so the two can be compared
// bit for bit over the whole output.
//
// Bound: bytes.  Each slot reads its index (4 bytes) and mask (1 byte)
// and writes C floats; x is read once if its rows stay in L2 (RCB point
// order keeps the rows of one block close).  Design: one thread per
// (row, slot), so consecutive threads write consecutive C-float records
// (coalesced stores); the mask is tested before the index is loaded, so
// padded slots (index 0 or -1) are never dereferenced.  C = 4 rows are
// moved as one float4 load and store when both x and out are 16-byte
// aligned; C = 3 has an unrolled path; any other C a loop.

#include "common.cuh"

namespace {

template <int kC>
__global__ void __launch_bounds__(smk::kBlock)
table_gather_kernel(const float* __restrict__ x,
                    const int* __restrict__ table,
                    const bool* __restrict__ mask, int64_t n_slots, int c,
                    float* __restrict__ out) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (s >= n_slots) return;
  const int cc = kC > 0 ? kC : c;
  float* o = out + s * cc;
  if (!mask[s]) {
#pragma unroll
    for (int k = 0; k < cc; ++k) o[k] = 0.0f;
    return;
  }
  const float* src = x + static_cast<int64_t>(__ldg(table + s)) * cc;
#pragma unroll
  for (int k = 0; k < cc; ++k) o[k] = __ldg(src + k);
}

__global__ void __launch_bounds__(smk::kBlock)
table_gather4_kernel(const float4* __restrict__ x,
                     const int* __restrict__ table,
                     const bool* __restrict__ mask, int64_t n_slots,
                     float4* __restrict__ out) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (s >= n_slots) return;
  out[s] = mask[s] ? __ldg(x + __ldg(table + s))
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

}  // namespace

extern "C" int smk_table_gather(const void* x, const void* table,
                                const void* mask, int n_rows, int width,
                                int c, void* out, void* stream) {
  const int64_t n_slots = static_cast<int64_t>(n_rows) * width;
  if (n_slots > 0 && c > 0) {
    const unsigned grid =
        static_cast<unsigned>((n_slots + smk::kBlock - 1) / smk::kBlock);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* xf = static_cast<const float*>(x);
    const int* tb = static_cast<const int*>(table);
    const bool* mk = static_cast<const bool*>(mask);
    float* of = static_cast<float*>(out);
    const bool aligned16 = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                           (reinterpret_cast<uintptr_t>(out) % 16 == 0);
    if (c == 4 && aligned16) {
      table_gather4_kernel<<<grid, smk::kBlock, 0, st>>>(
          static_cast<const float4*>(x), tb, mk, n_slots,
          static_cast<float4*>(out));
    } else if (c == 3) {
      table_gather_kernel<3><<<grid, smk::kBlock, 0, st>>>(
          xf, tb, mk, n_slots, c, of);
    } else {
      table_gather_kernel<0><<<grid, smk::kBlock, 0, st>>>(
          xf, tb, mk, n_slots, c, of);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
