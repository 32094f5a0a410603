// Per-row top-k selection mask and threshold by exact radix select.
//
// Replaces the Pallas kernel `topk_mask_threshold`
// (src/repro/kernels/randtopk/kernel.py:133, body `_topk_mask_kernel` :72
// and `_count_select` :40), which bisects a score range for 32 rounds of
// compare-and-count because the TPU has no cheap gather or sort.
//
// What bounds it on an H100: at serving shapes (one row of d = 4096, one
// launch per client token) it reads 8 KB and writes 4 KB, about 4 ns of
// HBM time, so launch latency and the block's serial passes set the pace,
// not bandwidth. The design keeps the whole row in shared memory and makes
// a fixed, short number of passes over it:
//   * one block per row; |x| staged once as f32 bit patterns (16 KB at
//     d = 4096; dynamic shared memory up to d = 16384). For non-negative
//     floats the bit patterns order like unsigned ints;
//   * the EXACT kth largest pattern from four 8-bit radix passes (shared
//     histogram, then one warp finds the bucket with a suffix scan), not
//     an approximate bisection band;
//   * mask = gt | (eq & rank <= need), rank the left-to-right count of
//     elements equal to the kth (warp ballot + popc, per-warp offsets):
//     exactly the XLA tie rule of `selection.topk_mask`.
// `fabsf` clears the sign of -0.0. NaN input is out of scope (its pattern
// sorts above +inf).
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxD = 16384;

__global__ void __launch_bounds__(kThreads)
topk_select_kernel(const void* x, int is_bf16, int d, int k, uint8_t* mask,
                   float* thr) {
  extern __shared__ unsigned keys[];            // d magnitude patterns
  __shared__ int hist[256];
  __shared__ int warp_sums[33];
  __shared__ unsigned s_prefix;
  __shared__ int s_remaining;
  const long long off = static_cast<long long>(blockIdx.x) * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x)
    keys[i] = __float_as_uint(fabsf(repro::load_f(x, is_bf16, off + i)));
  if (threadIdx.x == 0) {
    s_prefix = 0u;
    s_remaining = k;
  }
  unsigned prefix_mask = 0u;
  for (int pass = 3; pass >= 0; --pass) {
    const int shift = pass * 8;
    for (int b = threadIdx.x; b < 256; b += blockDim.x) hist[b] = 0;
    __syncthreads();
    const unsigned prefix = s_prefix;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const unsigned key = keys[i];
      if ((key & prefix_mask) == prefix)
        atomicAdd(&hist[(key >> shift) & 255u], 1);
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      // lane l owns buckets [8l, 8l + 8); suffix = count in lanes >= l
      const int lane = threadIdx.x;
      const int remaining = s_remaining;
      int local = 0;
      for (int j = 0; j < 8; ++j) local += hist[lane * 8 + j];
      int suffix = local;
      for (int o = 1; o < 32; o <<= 1) {
        const int down = __shfl_down_sync(repro::kFull, suffix, o);
        if (lane + o < 32) suffix += down;
      }
      const int above = suffix - local;
      if (above < remaining && suffix >= remaining) {   // exactly one lane
        int cum = above;
        for (int b = lane * 8 + 7; b >= lane * 8; --b) {
          cum += hist[b];
          if (cum >= remaining) {
            s_prefix = prefix | (static_cast<unsigned>(b) << shift);
            s_remaining = remaining - (cum - hist[b]);
            break;
          }
        }
      }
    }
    prefix_mask |= 255u << shift;
    __syncthreads();
  }
  const unsigned kth = s_prefix;
  const int need = s_remaining;   // elements equal to kth still to admit
  int running = 0;
  for (int base = 0; base < d; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const unsigned key = i < d ? keys[i] : 0u;
    const bool eq = i < d && key == kth;
    int total;
    const int before = repro::block_excl_prefix(eq, warp_sums, &total);
    if (i < d)
      mask[off + i] = (key > kth) || (eq && running + before + 1 <= need);
    running += total;
  }
  if (threadIdx.x == 0) thr[blockIdx.x] = __uint_as_float(kth);
}

}  // namespace

// x: (rows, d) f32 or bf16; mask: (rows, d) bytes 0/1; thr: (rows,) f32.
// Requires 1 <= k <= d <= 16384. Returns cudaGetLastError() of the launch.
extern "C" int topk_mask_threshold(const void* x, int is_bf16, int rows,
                                   int d, int k, void* mask, void* thr,
                                   void* stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaFuncSetAttribute(topk_select_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kMaxD * static_cast<int>(sizeof(unsigned)));
    attr_set = true;
  }
  topk_select_kernel<<<rows, kThreads, d * sizeof(unsigned),
                       static_cast<cudaStream_t>(stream)>>>(
      x, is_bf16, d, k, static_cast<uint8_t*>(mask),
      static_cast<float*>(thr));
  return static_cast<int>(cudaGetLastError());
}
