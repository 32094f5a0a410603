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

// Block-wide exclusive prefix sum of `v` in thread order: a warp
// __shfl_up_sync scan, then one scan of the per-warp totals by warp 0.
// Every thread of the block must call it (blockDim.x a multiple of 32,
// <= 1024). `warp_sums` is 33 ints of shared memory; the block total lands
// in `*total`. Ends with a barrier, so `warp_sums` is free again on return.
__device__ __forceinline__ int block_excl_sum(int v, int* warp_sums,
                                              int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < n_warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += up;
    }
    if (lane < n_warps) warp_sums[lane] = w;       // inclusive per warp
    if (lane == 31) warp_sums[32] = w;             // block total
  }
  __syncthreads();
  const int before = (warp ? warp_sums[warp - 1] : 0) + incl - v;
  *total = warp_sums[32];
  __syncthreads();
  return before;
}

// Order-preserving unsigned key of a float: a > b as floats iff
// float_key(a) > float_key(b). Negative floats (Gumbel scores can be) have
// their bits flipped, non-negative ones their sign bit set; -0.0 maps to
// the key of +0.0, since the two compare equal. Every non-NaN float maps
// above 0, so key 0 can stand for "not in the pool". NaN is out of scope.
__device__ __forceinline__ unsigned float_key(float f) {
  unsigned u = __float_as_uint(f);
  if ((u << 1) == 0u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Shared-memory scratch of one radix select: a 256-bucket histogram, the
// key prefix found so far, and how many keys of that prefix are still to
// admit.
struct RadixScratch {
  int hist[256];
  unsigned prefix;
  int remaining;
};

// The EXACT `target`-th largest of keys[0, d) (1 <= target <= d), from
// four 8-bit radix passes over the keys in shared memory: per pass a
// shared histogram of the keys that match the prefix found so far, then
// one warp finds the bucket that holds the target by a suffix scan.
// Returns the kth key; `*need` is how many keys EQUAL to it belong to the
// top `target` (the rest of the top are strictly greater). Every thread of
// the block must call it; it ends with a barrier.
__device__ __forceinline__ unsigned block_radix_kth(const unsigned* keys,
                                                    int d, int target,
                                                    RadixScratch* s,
                                                    int* need) {
  if (threadIdx.x == 0) {
    s->prefix = 0u;
    s->remaining = target;
  }
  unsigned prefix_mask = 0u;
  for (int pass = 3; pass >= 0; --pass) {
    const int shift = pass * 8;
    for (int b = threadIdx.x; b < 256; b += blockDim.x) s->hist[b] = 0;
    __syncthreads();
    const unsigned prefix = s->prefix;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const unsigned key = keys[i];
      if ((key & prefix_mask) == prefix)
        atomicAdd(&s->hist[(key >> shift) & 255u], 1);
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      // lane l owns buckets [8l, 8l + 8); suffix = count in lanes >= l
      const int lane = threadIdx.x;
      const int remaining = s->remaining;
      int local = 0;
      for (int j = 0; j < 8; ++j) local += s->hist[lane * 8 + j];
      int suffix = local;
      for (int o = 1; o < 32; o <<= 1) {
        const int down = __shfl_down_sync(kFull, suffix, o);
        if (lane + o < 32) suffix += down;
      }
      const int above = suffix - local;
      if (above < remaining && suffix >= remaining) {   // exactly one lane
        int cum = above;
        for (int b = lane * 8 + 7; b >= lane * 8; --b) {
          cum += s->hist[b];
          if (cum >= remaining) {
            s->prefix = prefix | (static_cast<unsigned>(b) << shift);
            s->remaining = remaining - (cum - s->hist[b]);
            break;
          }
        }
      }
    }
    prefix_mask |= 255u << shift;
    __syncthreads();
  }
  const unsigned kth = s->prefix;
  *need = s->remaining;
  __syncthreads();
  return kth;
}

// Calls emit(i, selected) once for every i in [0, d), where `selected` is
// key > kth, or key == kth and i among the first `need` such keys from the
// left: exactly the top `target` of `block_radix_kth`, ties admitted in
// index order (warp ballots + per-warp offsets). emit(i, .) runs on thread
// i % blockDim.x. Every thread of the block must call it.
template <class Emit>
__device__ __forceinline__ void block_emit_selected(const unsigned* keys,
                                                    int d, unsigned kth,
                                                    int need, int* warp_sums,
                                                    Emit emit) {
  int running = 0;
  for (int base = 0; base < d; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const unsigned key = i < d ? keys[i] : 0u;
    const bool eq = i < d && key == kth;
    int total;
    const int before = block_excl_prefix(eq, warp_sums, &total);
    if (i < d) emit(i, (key > kth) || (eq && running + before + 1 <= need));
    running += total;
  }
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
