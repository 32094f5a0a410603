// Fused payload encode: activation rows [+ selection mask] -> the wire
// leaves of any payload kind, one launch.
//
// Replaces the Pallas kernel `encode_rows_kernel`
// (src/repro/kernels/encode/kernel.py:160, bodies `_encode_block` :113,
// `_gather_block` :51, `_quant_block` :93, `_mask_words_block` :75). The
// TPU version compacts the support with a log-step lane prefix sum and a
// k-step compare-and-select loop because it has no cheap gather/scatter.
//
// What bounds it on an H100: at serving shapes (one row of d = 4096 bf16,
// k = 64) it moves about 13 KB, a few ns of HBM time, so launch latency
// and the block's barriers set the pace. The design is one block per row
// and one pass over it:
//   * gather (sparse, sparse_quant, mask): a block-exclusive scan of the
//     mask (warp ballot + popc, per-warp offsets) gives each set lane its
//     output position; the lane writes values[pos] and indices[pos]
//     directly when pos < k. Positions past the row's count stay zero;
//   * mask words: the ballot of lanes 32j..32j+31 IS word j (bit l%32 of
//     word l//32); lanes >= d vote 0;
//   * quant: a warp-shuffle min/max reduction, then floor((v - lo) / step)
//     clipped, with IEEE division, in both range variants of the
//     reference (`step <= 0 -> 1` over the full row; `hi > lo` over the
//     selected values, which sit in shared memory).
// Inputs are f32 or bf16 (read through __bfloat162float); outputs are f32
// values, int32 codes/indices and the u32 mask words.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxD = 16384;

__global__ void __launch_bounds__(kThreads)
encode_rows_kernel(const void* x, int is_bf16, const uint8_t* mask, int d,
                   int kind, int k, int bits, void* out0, void* out1,
                   void* out2) {
  extern __shared__ float sel[];                // k values (sparse_quant)
  __shared__ int warp_sums[33];
  __shared__ float red[64];
  const long long row = blockIdx.x;
  const long long xoff = row * d;
  const float n_bins = static_cast<float>(1 << bits);

  if (kind == repro::kDense || kind == repro::kSlice) {
    const int w = kind == repro::kDense ? d : k;
    float* o = static_cast<float*>(out0) + row * w;
    for (int i = threadIdx.x; i < w; i += blockDim.x)
      o[i] = repro::load_f(x, is_bf16, xoff + i);
    return;
  }
  if (kind == repro::kQuant) {
    float mn = INFINITY, mx = -INFINITY;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float v = repro::load_f(x, is_bf16, xoff + i);
      mn = fminf(mn, v);
      mx = fmaxf(mx, v);
    }
    float lo, hi;
    repro::block_minmax(mn, mx, red, &lo, &hi);
    float step = __fdiv_rn(__fsub_rn(hi, lo), n_bins);
    if (step <= 0.f) step = 1.f;
    int* codes = static_cast<int*>(out0) + row * d;
    for (int i = threadIdx.x; i < d; i += blockDim.x)
      codes[i] = repro::quant_code(repro::load_f(x, is_bf16, xoff + i), lo,
                                   step, n_bins);
    if (threadIdx.x == 0) {
      static_cast<float*>(out1)[row * 2] = lo;
      static_cast<float*>(out1)[row * 2 + 1] = step;
    }
    return;
  }

  // sparse / sparse_quant / mask: compact the masked lanes in index order
  const int nw = (d + 31) >> 5;
  float* vals = kind == repro::kSparseQuant
                    ? sel : static_cast<float*>(out0) + row * k;
  int* idx = kind == repro::kMask ? nullptr
             : static_cast<int*>(out1) + row * k;
  int running = 0;
  for (int base = 0; base < d; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const bool m = i < d && mask[xoff + i] != 0;
    int total;
    const int pos = running + repro::block_excl_prefix(m, warp_sums, &total);
    if (m && pos < k) {
      vals[pos] = repro::load_f(x, is_bf16, xoff + i);
      if (idx) idx[pos] = i;
    }
    if (kind == repro::kMask) {
      const unsigned word = __ballot_sync(repro::kFull, m);
      const int wi = (base >> 5) + (threadIdx.x >> 5);
      if ((threadIdx.x & 31) == 0 && wi < nw)
        static_cast<unsigned*>(out1)[row * nw + wi] = word;
    }
    running += total;
  }
  for (int j = min(running, k) + threadIdx.x; j < k; j += blockDim.x) {
    vals[j] = 0.f;
    if (idx) idx[j] = 0;
  }
  if (kind != repro::kSparseQuant) return;

  __syncthreads();                              // sel[] complete
  float mn = INFINITY, mx = -INFINITY;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    mn = fminf(mn, sel[j]);
    mx = fmaxf(mx, sel[j]);
  }
  float lo, hi;
  repro::block_minmax(mn, mx, red, &lo, &hi);
  const float step = hi > lo ? __fdiv_rn(__fsub_rn(hi, lo), n_bins) : 1.f;
  int* codes = static_cast<int*>(out0) + row * k;
  for (int j = threadIdx.x; j < k; j += blockDim.x)
    codes[j] = repro::quant_code(sel[j], lo, step, n_bins);
  if (threadIdx.x == 0) {
    static_cast<float*>(out2)[row * 2] = lo;
    static_cast<float*>(out2)[row * 2 + 1] = step;
  }
}

}  // namespace

// x: (rows, d) f32/bf16; mask: (rows, d) bytes 0/1 (mask kinds only).
// Outputs per kind (row-major, leading dim rows):
//   dense (d) f32 | slice (k) f32 | sparse (k) f32, (k) i32 |
//   quant (d) i32, (2) f32 | sparse_quant (k) i32, (k) i32, (2) f32 |
//   mask (k) f32, (ceil(d/32)) u32.
// Requires d <= 16384, 1 <= k <= d for the k kinds, 1 <= bits <= 8.
extern "C" int encode_rows(const void* x, int is_bf16, const void* mask,
                           int rows, int d, int kind, int k, int bits,
                           void* out0, void* out1, void* out2,
                           void* stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaFuncSetAttribute(encode_rows_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kMaxD * static_cast<int>(sizeof(float)));
    attr_set = true;
  }
  const size_t smem = kind == repro::kSparseQuant ? k * sizeof(float) : 0;
  encode_rows_kernel<<<rows, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      x, is_bf16, static_cast<const uint8_t*>(mask), d, kind, k, bits, out0,
      out1, out2);
  return static_cast<int>(cudaGetLastError());
}
