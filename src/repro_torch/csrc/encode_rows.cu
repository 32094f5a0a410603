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
// k = 64) it moves about 13 KB, a few ns of HBM time, so what sets the
// pace is latency: the launch, the dependent loads and the block's
// barriers. The design is one block per row and one pass over it, with as
// few barriers as the compaction allows:
//   * each thread owns a run of 16 consecutive elements (256 threads cover
//     d = 4096; narrower rows take fewer warps, at least one). It loads
//     its run of x and of the mask bytes with 16-byte loads where the row
//     is aligned (two of bf16 or four of f32, one of mask bytes) and
//     counts its set lanes in registers;
//   * one block-exclusive scan (`block_excl_sum`: a warp __shfl_up_sync
//     scan plus one pass over the warp totals, three barriers) gives every
//     thread the output position of its first set lane; it writes its
//     selected values and indices below k. Rows wider than 16 x 256 walk
//     chunks of that size with a running offset (4 scans at d = 16384).
//     Positions past the row's count stay zero;
//   * mask words: a thread's 16 bits and its right neighbour's, joined by
//     a shuffle, are word j (bit l%32 of word l//32); lanes >= d are 0;
//   * quant: min/max reduced from the registers (`block_minmax`), then
//     floor((v - lo) / step) clipped, with IEEE division, from the same
//     registers, so x is read once (twice above d = 4096). Both range
//     variants of the reference: `step <= 0 -> 1` over the full row;
//     `hi > lo` over the selected values, which sit in shared memory.
// Rows that are not 16-byte aligned (d not a multiple of 16, or a pointer
// off a 16-byte boundary) load and store one element at a time.
// Inputs are f32 or bf16 (a bf16 is the top half of its f32); outputs are
// f32 values, int32 codes/indices and the u32 mask words.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;    // most threads a row's block takes
constexpr int kRun = 16;         // consecutive elements a thread owns
constexpr int kMaxD = 16384;

// A thread's run of row elements [c0, c0 + kRun): the values as f32 and a
// bit per element whose mask byte is nonzero (when `mask` is given).
// Elements at or past d read as 0 with their bit clear.
struct Run {
  float v[kRun];
  unsigned bits;
};

// `vec`: d % kRun == 0 and x, mask start 16-byte aligned, so a run is
// whole 16-byte vectors.
__device__ __forceinline__ void load_run(const void* x, int is_bf16,
                                         const uint8_t* mask,
                                         long long row_off, int c0, int d,
                                         bool vec, Run& r) {
  r.bits = 0u;
  if (!vec) {
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const int c = c0 + j;
      const bool in = c < d;
      r.v[j] = in ? repro::load_f(x, is_bf16, row_off + c) : 0.f;
      if (mask != nullptr && in && mask[row_off + c] != 0) r.bits |= 1u << j;
    }
    return;
  }
  if (c0 >= d) {
#pragma unroll
    for (int j = 0; j < kRun; ++j) r.v[j] = 0.f;
    return;
  }
  if (is_bf16) {
    const uint4* p = reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(x) + row_off + c0);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const uint4 u = p[q];
      const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        r.v[q * 8 + 2 * j] = __uint_as_float(w[j] << 16);
        r.v[q * 8 + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
      }
    }
  } else {
    const float4* p = reinterpret_cast<const float4*>(
        static_cast<const float*>(x) + row_off + c0);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 f = p[q];
      r.v[4 * q] = f.x;
      r.v[4 * q + 1] = f.y;
      r.v[4 * q + 2] = f.z;
      r.v[4 * q + 3] = f.w;
    }
  }
  if (mask != nullptr) {
    const uint4 m = *reinterpret_cast<const uint4*>(mask + row_off + c0);
    const unsigned w[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
    for (int j = 0; j < kRun; ++j)
      if ((w[j >> 2] >> ((j & 3) * 8)) & 0xffu) r.bits |= 1u << j;
  }
}

__device__ __forceinline__ void run_minmax(const Run& r, int c0, int d,
                                           float& mn, float& mx) {
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    if (c0 + j < d) {
      mn = fminf(mn, r.v[j]);
      mx = fmaxf(mx, r.v[j]);
    }
  }
}

// Codes of a run into codes[c0, c0 + kRun) below d: one 16-byte store per
// 4 codes when `vec` (then codes + c0 is 16-byte aligned).
__device__ __forceinline__ void store_codes(const Run& r, int c0, int d,
                                            bool vec, float lo, float step,
                                            float n_bins, int* codes) {
  int c[kRun];
#pragma unroll
  for (int j = 0; j < kRun; ++j)
    c[j] = repro::quant_code(r.v[j], lo, step, n_bins);
  if (vec) {
    if (c0 >= d) return;
    int4* p = reinterpret_cast<int4*>(codes + c0);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      p[q] = make_int4(c[4 * q], c[4 * q + 1], c[4 * q + 2], c[4 * q + 3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < kRun; ++j)
    if (c0 + j < d) codes[c0 + j] = c[j];
}

__global__ void __launch_bounds__(kThreads)
encode_rows_kernel(const void* x, int is_bf16, const uint8_t* mask, int d,
                   int kind, int k, int bits, int vec_rows, void* out0,
                   void* out1, void* out2) {
  extern __shared__ float sel[];                // k values (sparse_quant)
  __shared__ int warp_sums[33];
  __shared__ float red[64];
  const long long row = blockIdx.x;
  const long long xoff = row * d;
  const float n_bins = static_cast<float>(1 << bits);
  const bool vec = vec_rows != 0;
  const int chunk = blockDim.x * kRun;
  const int mine = threadIdx.x * kRun;          // run offset in a chunk
  Run r;

  if (kind == repro::kDense || kind == repro::kSlice) {
    const int w = kind == repro::kDense ? d : k;
    float* o = static_cast<float*>(out0) + row * w;
    for (int base = 0; base < w; base += chunk) {
      const int c0 = base + mine;
      load_run(x, is_bf16, nullptr, xoff, c0, d, vec, r);
      if (vec && kind == repro::kDense) {
        if (c0 >= d) continue;
        float4* p = reinterpret_cast<float4*>(o + c0);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          p[q] = make_float4(r.v[4 * q], r.v[4 * q + 1], r.v[4 * q + 2],
                             r.v[4 * q + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < kRun; ++j)
          if (c0 + j < w) o[c0 + j] = r.v[j];
      }
    }
    return;
  }

  if (kind == repro::kQuant) {
    // the first chunk stays in registers from the min/max to the codes
    float mn = INFINITY, mx = -INFINITY;
    load_run(x, is_bf16, nullptr, xoff, mine, d, vec, r);
    run_minmax(r, mine, d, mn, mx);
    for (int base = chunk; base < d; base += chunk) {
      Run t;
      load_run(x, is_bf16, nullptr, xoff, base + mine, d, vec, t);
      run_minmax(t, base + mine, d, mn, mx);
    }
    float lo, hi;
    repro::block_minmax(mn, mx, red, &lo, &hi);
    float step = __fdiv_rn(__fsub_rn(hi, lo), n_bins);
    if (step <= 0.f) step = 1.f;
    int* codes = static_cast<int*>(out0) + row * d;
    store_codes(r, mine, d, vec, lo, step, n_bins, codes);
    for (int base = chunk; base < d; base += chunk) {
      Run t;
      load_run(x, is_bf16, nullptr, xoff, base + mine, d, vec, t);
      store_codes(t, base + mine, d, vec, lo, step, n_bins, codes);
    }
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
  unsigned* words = kind == repro::kMask
                        ? static_cast<unsigned*>(out1) + row * nw : nullptr;
  int running = 0;
  for (int base = 0; base < d; base += chunk) {
    const int c0 = base + mine;
    load_run(x, is_bf16, mask, xoff, c0, d, vec, r);
    int total;
    int pos = running + repro::block_excl_sum(__popc(r.bits), warp_sums,
                                              &total);
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      if ((r.bits >> j) & 1u) {
        if (pos < k) {
          vals[pos] = r.v[j];
          if (idx != nullptr) idx[pos] = c0 + j;
        }
        ++pos;
      }
    }
    if (words != nullptr) {
      // an even thread's run starts a word; its neighbour holds the top half
      const unsigned hi = __shfl_down_sync(repro::kFull, r.bits, 1);
      if ((threadIdx.x & 1) == 0 && (c0 >> 5) < nw)
        words[c0 >> 5] = r.bits | (hi << 16);
    }
    running += total;
  }
  for (int j = min(running, k) + threadIdx.x; j < k; j += blockDim.x) {
    vals[j] = 0.f;
    if (idx != nullptr) idx[j] = 0;
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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// x: (rows, d) f32/bf16; mask: (rows, d) bytes, nonzero = selected (mask
// kinds only). Outputs per kind (row-major, leading dim rows):
//   dense (d) f32 | slice (k) f32 | sparse (k) f32, (k) i32 |
//   quant (d) i32, (2) f32 | sparse_quant (k) i32, (k) i32, (2) f32 |
//   mask (k) f32, (ceil(d/32)) u32.
// Requires 1 <= d <= 16384, 1 <= k <= d for the k kinds, 1 <= bits <= 8.
extern "C" int encode_rows(const void* x, int is_bf16, const void* mask,
                           int rows, int d, int kind, int k, int bits,
                           void* out0, void* out1, void* out2,
                           void* stream) {
  if (d < 1 || d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;
  if (!attr_set) {
    cudaFuncSetAttribute(encode_rows_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kMaxD * static_cast<int>(sizeof(float)));
    attr_set = true;
  }
  const int runs = (d + kRun - 1) / kRun;
  const int threads = min(kThreads, max(32, (runs + 31) / 32 * 32));
  const int vec = d % kRun == 0 && aligned16(x) && aligned16(out0) &&
                  (mask == nullptr || aligned16(mask));
  const size_t smem = kind == repro::kSparseQuant ? k * sizeof(float) : 0;
  encode_rows_kernel<<<rows, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      x, is_bf16, static_cast<const uint8_t*>(mask), d, kind, k, bits, vec,
      out0, out1, out2);
  return static_cast<int>(cudaGetLastError());
}
