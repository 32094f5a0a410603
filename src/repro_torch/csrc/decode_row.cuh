// Shared-memory row helpers of the decode family (header only):
//   * `decode_row`, the per-kind payload row decode of
//     `decode_to_slots.cu`: the `_decode_block` of
//     src/repro/kernels/decode/kernel.py:124 with its `_scatter_block` :61,
//     `_dequant_block` :54 and `_mask_expand_block` :108, as one pass of a
//     block over one row held in shared memory;
//   * `zero_shared` and `store_row`, with which `decode_to_slots.cu` zeroes
//     its shared row and stores it to device memory as 16-byte vectors
//     (`store_flat`), every element converted exactly as a single store
//     would; `decode_rows.cu` shares `zero_shared` (its k > d path),
//     `store_one` and `pack_bf16x8`.
#pragma once

#include "common.cuh"

namespace repro {

// Zero n floats of shared memory from `buf`: 16-byte stores where `buf`
// is 16-byte aligned, the rest one float at a time.
__device__ __forceinline__ void zero_shared(float* buf, int n) {
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(buf) & 15) == 0) {
    float4* b4 = reinterpret_cast<float4*>(buf);
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x)
      b4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    head = n / 4 * 4;
  }
  for (int i = head + threadIdx.x; i < n; i += blockDim.x) buf[i] = 0.f;
}

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
  zero_shared(row, d);
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

__device__ __forceinline__ void store_one(float* o, float v) { *o = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}

// 8 floats rounded to nearest bf16, packed in order into one 16-byte
// vector.
__device__ __forceinline__ uint4 pack_bf16x8(const float* f) {
  unsigned u[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 h =
        __halves2bfloat162(__float2bfloat16_rn(f[2 * j]),
                           __float2bfloat16_rn(f[2 * j + 1]));
    u[j] = *reinterpret_cast<const unsigned*>(&h);
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// Store n floats of shared memory `src` to `out` (T = float, or bf16
// rounded to nearest), coalesced: 16-byte stores of 4 floats or 8 bf16
// from the first 16-byte boundary of `out`, single elements before it and
// after the last whole vector. Every element is converted exactly as a
// single store would, so the result does not depend on the alignment.
template <typename T>
__device__ __forceinline__ void store_flat(const float* src, int n, T* out) {
  constexpr int V = 16 / sizeof(T);
  const int mis = static_cast<int>(
      (reinterpret_cast<uintptr_t>(out) / sizeof(T)) % V);
  const int head = min(n, mis ? V - mis : 0);
  const int nv = (n - head) / V;
  for (int i = threadIdx.x; i < head; i += blockDim.x)
    store_one(out + i, src[i]);
  const bool src4 = ((reinterpret_cast<uintptr_t>(src + head) & 15) == 0);
  for (int c = threadIdx.x; c < nv; c += blockDim.x) {
    const int i = head + c * V;
    float f[V];
    if (src4) {
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        const float4 x = *reinterpret_cast<const float4*>(src + i + j);
        f[j] = x.x; f[j + 1] = x.y; f[j + 2] = x.z; f[j + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) f[j] = src[i + j];
    }
    if constexpr (V == 4)
      *reinterpret_cast<uint4*>(out + i) =
          make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                     __float_as_uint(f[2]), __float_as_uint(f[3]));
    else
      *reinterpret_cast<uint4*>(out + i) = pack_bf16x8(f);
  }
  for (int i = head + nv * V + threadIdx.x; i < n; i += blockDim.x)
    store_one(out + i, src[i]);
}

// Store `row` (d floats of shared memory) to `out` (d elements of f32, or
// bf16 rounded to nearest when `out_bf16`), coalesced (`store_flat`).
__device__ __forceinline__ void store_row(const float* row, int d, void* out,
                                          int out_bf16) {
  if (out_bf16)
    store_flat(row, d, static_cast<__nv_bfloat16*>(out));
  else
    store_flat(row, d, static_cast<float*>(out));
}

}  // namespace repro
