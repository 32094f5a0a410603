// Per-row top-k selection mask and threshold by exact radix select.
//
// Replaces the Pallas kernel `topk_mask_threshold`
// (src/repro/kernels/randtopk/kernel.py:133, body `_topk_mask_kernel` :72
// and `_count_select` :40), which bisects a score range for 32 rounds of
// compare-and-count because the TPU has no cheap gather or sort.
//
// Where its work runs now: the serving client's top-k goes inside the
// fused encode (`encode_rows.cu`, `select=`), so no byte mask reaches
// device memory there; this kernel serves the callers that want the mask
// itself (the tabular trainer, `error_feedback`, the checks).
//
// What bounds it on an H100: at serving shapes (one row of d = 4096, one
// launch per client token) it reads 8 KB and writes 4 KB, about 4 ns of
// HBM time, so launch latency and the block's serial passes set the pace,
// not bandwidth. The design keeps each row in registers and makes as few
// passes as the keys need:
//   * one block per row; each thread holds a run of consecutive elements
//     (vector loads where the row is aligned): 4 up to d = 512, so a
//     128-wide row fills one warp, else 16, so d = 4096 takes 256 threads
//     and d = 16384 takes 1024; the row is read once;
//   * the EXACT kth largest |x| by radix passes over the registers
//     (`team_select` in common.cuh): a bf16 magnitude has 15 significant
//     bits, so two passes; an f32 one has 31, at most four, fewer when the
//     bucket that holds the kth is taken whole;
//   * mask = gt | (eq & rank < need), rank the left-to-right count of
//     elements in the boundary bucket: exactly the XLA tie rule of
//     `selection.topk_mask`. The rank needs one scan, run only when the
//     bucket holds more keys than it admits;
//   * the mask row is stored as whole words per thread.
// `fabsf` clears the sign of -0.0. NaN input is out of scope (its pattern
// sorts above +inf).
#include "common.cuh"

namespace {

template <int R>
__global__ void __launch_bounds__(1024)
topk_select_kernel(const void* x, int is_bf16, int d, int k, int vec,
                   uint8_t* mask, float* thr) {
  __shared__ repro::TeamScratch scratch;
  const repro::Team t{0, static_cast<int>(blockDim.x),
                      static_cast<int>(threadIdx.x), &scratch};
  const long long off = static_cast<long long>(blockIdx.x) * d;
  const int c0 = t.rank * R;
  repro::Run<R> r;
  repro::load_run<R>(x, is_bf16, nullptr, off, c0, d, vec != 0, r);
  const unsigned valid = repro::run_valid<R>(c0, d);
  auto key = [&](int j) { return repro::mag_key(r.v[j], is_bf16); };
  const repro::Cut c =
      repro::team_select<R>(key, valid, repro::mag_bits(is_bf16), k, t);
  unsigned gt, eq;
  repro::cut_bits<R>(key, valid, c, &gt, &eq);
  int eq_before = 0, total;
  if (c.ties) eq_before = repro::team_excl_sum(__popc(eq), t, &total);
  const unsigned sel =
      repro::admit<R>(gt, eq, eq_before, c.ties ? c.need : repro::kAll);
  repro::store_bytes<R>(mask + off + c0, sel, vec != 0, d - c0);
  // the kth |x|: the bucket itself after the last pass, else its smallest
  // key (the whole bucket is in the top)
  unsigned kth = c.prefix;
  if (c.hi > 0) {
    unsigned mn = ~0u;
#pragma unroll
    for (int j = 0; j < R; ++j)
      if ((eq >> j) & 1u) mn = min(mn, key(j));
    kth = repro::team_min_u32(mn, t);
  }
  if (t.rank == 0) thr[blockIdx.x] = __uint_as_float(is_bf16 ? kth << 16
                                                             : kth);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// x: (rows, d) f32 or bf16; mask: (rows, d) bytes 0/1; thr: (rows,) f32.
// Requires 1 <= k <= d <= 16384. Returns cudaGetLastError() of the launch.
extern "C" int topk_mask_threshold(const void* x, int is_bf16, int rows,
                                   int d, int k, void* mask, void* thr,
                                   void* stream) {
  if (d < 1 || d > repro::kMaxD || k < 1 || k > d)
    return static_cast<int>(cudaErrorInvalidValue);
  const int run = repro::run_len(d);
  const int vec = d % run == 0 && aligned16(x) && aligned16(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* m = static_cast<uint8_t*>(mask);
  float* t = static_cast<float*>(thr);
  if (run == repro::kRunNarrow)
    topk_select_kernel<repro::kRunNarrow>
        <<<rows, repro::row_threads(d, run), 0, s>>>(x, is_bf16, d, k, vec,
                                                     m, t);
  else
    topk_select_kernel<repro::kRunWide>
        <<<rows, repro::row_threads(d, run), 0, s>>>(x, is_bf16, d, k, vec,
                                                     m, t);
  return static_cast<int>(cudaGetLastError());
}
