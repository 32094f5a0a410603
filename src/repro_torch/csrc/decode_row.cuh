// The per-kind payload row decode shared by `decode_rows.cu` and
// `decode_to_slots.cu` (header only): the `_decode_block` of
// src/repro/kernels/decode/kernel.py:124 with its `_scatter_block` :61,
// `_dequant_block` :54 and `_mask_expand_block` :108, as one pass of a
// block over one row held in shared memory.
#pragma once

#include "common.cuh"

namespace repro {

// Builds the dense f32 row r of a payload of `kind` in `row` (d floats of
// shared memory): zero it, barrier, then
//   dense / slice     copy the d (or k) values;
//   sparse            shared atomicAdd of each value at its index, so
//                     duplicate indices sum as in the Pallas accumulate;
//                     indices outside [0, d) are dropped, as no Pallas
//                     lane matches them;
//   quant             lo + (code + 0.5) * step with separate roundings;
//   sparse_quant      the same dequant, then the sparse scatter;
//   mask              value j lands on the lane of the (j+1)-th set bit of
//                     the packed u32 words (a block prefix count of the set
//                     bits); set bits past k expand to 0.
// Values are f32, or bf16 when `vals_bf16`; codes and indices int32; the
// mask words are the int32 bit patterns of u32 words; header is (rows, 2)
// f32. `warp_sums` is 33 ints of shared memory. Every thread of the block
// must call it; it ends with a barrier, so `row` is complete on return.
__device__ __forceinline__ void decode_row(float* row, int d, long long r,
                                           int kind, int k,
                                           const void* values, int vals_bf16,
                                           const int* indices,
                                           const float* header,
                                           int* warp_sums) {
  const int* codes = static_cast<const int*>(values);
  for (int i = threadIdx.x; i < d; i += blockDim.x) row[i] = 0.f;
  __syncthreads();
  float lo = 0.f, step = 0.f;
  if (kind == kQuant || kind == kSparseQuant) {
    lo = header[r * 2];
    step = header[r * 2 + 1];
  }
  if (kind == kDense) {
    for (int i = threadIdx.x; i < d; i += blockDim.x)
      row[i] = load_f(values, vals_bf16, r * d + i);
  } else if (kind == kSlice) {
    for (int i = threadIdx.x; i < k; i += blockDim.x)
      row[i] = load_f(values, vals_bf16, r * k + i);
  } else if (kind == kQuant) {
    for (int i = threadIdx.x; i < d; i += blockDim.x)
      row[i] = dequant(codes[r * d + i], lo, step);
  } else if (kind == kSparse || kind == kSparseQuant) {
    for (int j = threadIdx.x; j < k; j += blockDim.x) {
      const int at = indices[r * k + j];
      if (at < 0 || at >= d) continue;
      const float v = kind == kSparse
                          ? load_f(values, vals_bf16, r * k + j)
                          : dequant(codes[r * k + j], lo, step);
      atomicAdd(&row[at], v);
    }
  } else if (kind == kMask) {
    const int nw = (d + 31) >> 5;
    const unsigned* words = reinterpret_cast<const unsigned*>(indices) +
                            r * nw;
    int running = 0;
    for (int base = 0; base < d; base += blockDim.x) {
      const int i = base + threadIdx.x;
      const bool bit = i < d && ((words[i >> 5] >> (i & 31)) & 1u);
      int total;
      const int pos = running + block_excl_prefix(bit, warp_sums, &total);
      if (bit && pos < k) row[i] = load_f(values, vals_bf16, r * k + pos);
      running += total;
    }
  }
  __syncthreads();
}

// Store `row` (d floats of shared memory) to `out` (d elements of f32, or
// bf16 rounded to nearest when `out_bf16`), coalesced.
__device__ __forceinline__ void store_row(const float* row, int d, void* out,
                                          int out_bf16) {
  if (out_bf16) {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
    for (int i = threadIdx.x; i < d; i += blockDim.x)
      o[i] = __float2bfloat16_rn(row[i]);
  } else {
    float* o = static_cast<float*>(out);
    for (int i = threadIdx.x; i < d; i += blockDim.x) o[i] = row[i];
  }
}

}  // namespace repro
