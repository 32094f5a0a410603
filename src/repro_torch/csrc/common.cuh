// Shared device helpers of the port's kernels (header only).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr unsigned kFull = 0xffffffffu;

// The payload kinds, numbered as `core.payload.KINDS` (the wire's index).
enum Kind { kDense = 0, kSlice = 1, kSparse = 2, kQuant = 3,
            kSparseQuant = 4, kMask = 5 };

__device__ __forceinline__ float load_f(const void* x, int is_bf16,
                                        long long i) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i])
                 : static_cast<const float*>(x)[i];
}

// Block-wide exclusive prefix count of `flag` in thread order, from warp
// ballots and popcounts plus one scan over the per-warp totals. Every
// thread of the block must call it (blockDim.x a multiple of 32, <= 1024).
// `warp_sums` is 33 ints of shared memory; the block total lands in
// `*total`. Ends with a barrier, so `warp_sums` is free again on return.
__device__ __forceinline__ int block_excl_prefix(bool flag, int* warp_sums,
                                                 int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const unsigned ballot = __ballot_sync(kFull, flag);
  const int in_warp = __popc(ballot & ((1u << lane) - 1u));
  if (lane == 0) warp_sums[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    int v = lane < n_warps ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(kFull, v, o);
      if (lane >= o) v += up;
    }
    if (lane < n_warps) warp_sums[lane] = v;       // inclusive per warp
    if (lane == 31) warp_sums[32] = v;             // block total
  }
  __syncthreads();
  const int before = (warp ? warp_sums[warp - 1] : 0) + in_warp;
  *total = warp_sums[32];
  __syncthreads();
  return before;
}

// Block-wide min and max (every thread gets both). `red` is 64 floats of
// shared memory. NaN inputs are out of scope.
__device__ __forceinline__ void block_minmax(float mn, float mx, float* red,
                                             float* lo, float* hi) {
  for (int o = 16; o > 0; o >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(kFull, mn, o));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  if (lane == 0) {
    red[warp] = mn;
    red[32 + warp] = mx;
  }
  __syncthreads();
  if (warp == 0) {
    mn = lane < n_warps ? red[lane] : INFINITY;
    mx = lane < n_warps ? red[32 + lane] : -INFINITY;
    for (int o = 16; o > 0; o >>= 1) {
      mn = fminf(mn, __shfl_xor_sync(kFull, mn, o));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    }
    if (lane == 0) {
      red[0] = mn;
      red[32] = mx;
    }
  }
  __syncthreads();
  *lo = red[0];
  *hi = red[32];
  __syncthreads();
}

// floor((v - lo) / step) clipped to [0, n_bins - 1], with IEEE division
// (the build does not use --use_fast_math): the reference's quant grid.
__device__ __forceinline__ int quant_code(float v, float lo, float step,
                                          float n_bins) {
  float q = floorf(__fdiv_rn(__fsub_rn(v, lo), step));
  q = fminf(fmaxf(q, 0.f), n_bins - 1.f);
  return static_cast<int>(q);
}

// lo + (code + 0.5) * step, each operation rounded on its own (no FMA
// contraction), so the kernel agrees bit for bit with the plain version.
__device__ __forceinline__ float dequant(int code, float lo, float step) {
  return __fadd_rn(lo, __fmul_rn(__fadd_rn(static_cast<float>(code), 0.5f),
                                 step));
}

}  // namespace repro
