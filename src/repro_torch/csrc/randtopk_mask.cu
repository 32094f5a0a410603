// The Eq. (7) randomized top-k selection mask, exactly k per row.
//
// Replaces the Pallas kernel `randtopk_mask_kernel`
// (src/repro/kernels/randtopk/kernel.py:162, body `_randtopk_mask_kernel`
// :84 and `_count_select` :40), which runs a 32-round compare-and-count
// bisection three times per row tile because the TPU has no cheap gather
// or sort.
//
// What it computes: the |x| top-k pool, then the k - m largest Gumbel
// scores inside the pool and the m largest outside it (a Gumbel race, i.e.
// uniform picks without replacement). The noise and the per-row pick
// count m ~ Binomial(k, alpha) are drawn by the caller and come in as
// data, so the kernel is a deterministic function of its operands.
// m is clipped to [0, min(k, d - k)]; a zero target selects nothing.
// Ties are admitted in index order, so every row selects exactly k — the
// Pallas kernel's exact-count contract.
//
// What bounds it on an H100: at the training shapes (1024 rows of d = 4096,
// bf16 x, f32 noise) it reads 8 + 16 KB and writes 4 KB per row, 29 MB in
// all, about 9 us of HBM time; the three selects are 15 passes over the row
// in shared memory, so shared-memory traffic, not HBM, sets the pace. The
// design keeps the row on chip and makes a fixed number of passes:
//   * one block per row; keys[d] (u32) and a flag byte per element in
//     dynamic shared memory (5 B per element, 80 KB at d = 16384);
//   * select 1: |x| bit patterns, target k, the exact radix select of
//     `topk_select.cu` (`block_radix_kth`), pool = flag bit 0;
//   * selects 2 and 3: the Gumbel scores mapped to order-preserving u32
//     keys (`float_key`, since scores can be negative), with key 0 for the
//     elements outside the restricted set, targets k - m and m; picks set
//     flag bit 1. Key 0 is below every real score, so it is never picked
//     while the target does not exceed the set's size;
//   * one coalesced store of flag bit 1 as the mask.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxD = 16384;

__global__ void __launch_bounds__(kThreads)
randtopk_mask_kernel(const void* x, int is_bf16, const float* gumbel,
                     const int* m_in, int d, int k, uint8_t* mask) {
  extern __shared__ unsigned keys[];            // d keys, then d flag bytes
  uint8_t* flag = reinterpret_cast<uint8_t*>(keys + d);
  __shared__ repro::RadixScratch scratch;
  __shared__ int warp_sums[33];
  const long long off = static_cast<long long>(blockIdx.x) * d;
  const int m = min(max(m_in[blockIdx.x], 0), min(k, d - k));

  for (int i = threadIdx.x; i < d; i += blockDim.x)
    keys[i] = __float_as_uint(fabsf(repro::load_f(x, is_bf16, off + i)));
  __syncthreads();
  int need;
  unsigned kth = repro::block_radix_kth(keys, d, k, &scratch, &need);
  repro::block_emit_selected(keys, d, kth, need, warp_sums,
                             [&](int i, bool sel) { flag[i] = sel; });
  __syncthreads();

  // k - m picks inside the pool, then m outside it
  for (int inside = 1; inside >= 0; --inside) {
    const int target = inside ? k - m : m;
    if (target == 0) continue;                  // uniform across the block
    for (int i = threadIdx.x; i < d; i += blockDim.x)
      keys[i] = (flag[i] & 1) == inside
                    ? repro::float_key(gumbel[off + i]) : 0u;
    __syncthreads();
    kth = repro::block_radix_kth(keys, d, target, &scratch, &need);
    repro::block_emit_selected(keys, d, kth, need, warp_sums,
                               [&](int i, bool sel) {
                                 if (sel) flag[i] |= 2;
                               });
    __syncthreads();
  }
  for (int i = threadIdx.x; i < d; i += blockDim.x)
    mask[off + i] = flag[i] >> 1;
}

}  // namespace

// x: (rows, d) f32 or bf16; gumbel: (rows, d) f32; m: (rows,) int32;
// mask: (rows, d) bytes 0/1. Requires 1 <= k <= d <= 16384. Returns
// cudaGetLastError() of the launch.
extern "C" int randtopk_mask(const void* x, int is_bf16, const void* gumbel,
                             const void* m, int rows, int d, int k,
                             void* mask, void* stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaFuncSetAttribute(randtopk_mask_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kMaxD * static_cast<int>(sizeof(unsigned) + 1));
    attr_set = true;
  }
  randtopk_mask_kernel<<<rows, kThreads,
                         d * (sizeof(unsigned) + sizeof(uint8_t)),
                         static_cast<cudaStream_t>(stream)>>>(
      x, is_bf16, static_cast<const float*>(gumbel),
      static_cast<const int*>(m), d, k, static_cast<uint8_t*>(mask));
  return static_cast<int>(cudaGetLastError());
}
