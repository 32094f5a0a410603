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
//   * the EXACT kth largest pattern from four 8-bit radix passes
//     (`block_radix_kth` in common.cuh), not an approximate bisection band;
//   * mask = gt | (eq & rank <= need), rank the left-to-right count of
//     elements equal to the kth (`block_emit_selected`): exactly the XLA
//     tie rule of `selection.topk_mask`.
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
  __shared__ repro::RadixScratch scratch;
  __shared__ int warp_sums[33];
  const long long off = static_cast<long long>(blockIdx.x) * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x)
    keys[i] = __float_as_uint(fabsf(repro::load_f(x, is_bf16, off + i)));
  __syncthreads();
  int need;
  const unsigned kth = repro::block_radix_kth(keys, d, k, &scratch, &need);
  repro::block_emit_selected(keys, d, kth, need, warp_sums,
                             [&](int i, bool sel) { mask[off + i] = sel; });
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
