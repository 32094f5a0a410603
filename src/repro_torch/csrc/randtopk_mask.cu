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
// all, about 9 us of HBM time; the three selects make up to ten radix
// passes over each row, so the passes, not HBM, set the pace. The design
// keeps the row in registers and shares the select of `topk_select.cu`:
//   * one block per row; each thread holds a run of consecutive elements
//     of x and of the noise (vector loads where the row is aligned): 4 up
//     to d = 512, so a 128-wide row fills one warp, else 16;
//   * select 1: |x| magnitude keys, target k (`team_select`, two passes
//     for bf16), pool = its admitted bits;
//   * selects 2 and 3: the Gumbel scores as order-preserving u32 keys
//     (`float_key`, since scores can be negative), restricted to the pool
//     and to the rest by the `valid` bits, targets k - m and m; ties are
//     admitted left to right by one scan where the boundary bucket holds
//     more keys than it admits;
//   * the picks are stored as whole mask words per thread.
#include "common.cuh"

namespace {

// The selected bits of a run under a Cut, with the tie rank's scan run
// only when the boundary bucket has ties to break.
template <int R, class KeyOf>
__device__ __forceinline__ unsigned selected(KeyOf key, unsigned valid,
                                             const repro::Cut& c,
                                             const repro::Team& t) {
  unsigned gt, eq;
  repro::cut_bits<R>(key, valid, c, &gt, &eq);
  int eq_before = 0, total;
  if (c.ties) eq_before = repro::team_excl_sum(__popc(eq), t, &total);
  return repro::admit<R>(gt, eq, eq_before, c.ties ? c.need : repro::kAll);
}

template <int kMaxThreads, int R>
__global__ void __launch_bounds__(kMaxThreads)
randtopk_mask_kernel(const void* x, int is_bf16, const float* gumbel,
                     const int* m_in, int d, int k, int vec, uint8_t* mask) {
  __shared__ repro::TeamScratch scratch;
  const repro::Team t{0, static_cast<int>(blockDim.x),
                      static_cast<int>(threadIdx.x), &scratch};
  const long long off = static_cast<long long>(blockIdx.x) * d;
  const int m = min(max(m_in[blockIdx.x], 0), min(k, d - k));
  const int c0 = t.rank * R;
  const unsigned valid = repro::run_valid<R>(c0, d);
  repro::Run<R> r, g;
  repro::load_run<R>(x, is_bf16, nullptr, off, c0, d, vec != 0, r);
  repro::load_run<R>(gumbel, 0, nullptr, off, c0, d, vec != 0, g);

  auto mag = [&](int j) { return repro::mag_key(r.v[j], is_bf16); };
  const unsigned pool = selected<R>(
      mag, valid, repro::team_select<R>(mag, valid, repro::mag_bits(is_bf16),
                                        k, t), t);
  // k - m picks inside the pool, then m outside it
  auto score = [&](int j) { return repro::float_key(g.v[j]); };
  unsigned picks = 0u;
  for (int inside = 1; inside >= 0; --inside) {
    const int target = inside ? k - m : m;
    if (target == 0) continue;                  // uniform across the block
    const unsigned set = inside ? pool : valid & ~pool;
    picks |= selected<R>(score, set,
                         repro::team_select<R>(score, set, 32, target, t),
                         t);
  }
  repro::store_bytes<R>(mask + off + c0, picks, vec != 0, d - c0);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// x: (rows, d) f32 or bf16; gumbel: (rows, d) f32; m: (rows,) int32;
// mask: (rows, d) bytes 0/1. Requires 1 <= k <= d <= 16384. Returns
// cudaGetLastError() of the launch.
extern "C" int randtopk_mask(const void* x, int is_bf16, const void* gumbel,
                             const void* m, int rows, int d, int k,
                             void* mask, void* stream) {
  if (d < 1 || d > repro::kMaxD || k < 1 || k > d)
    return static_cast<int>(cudaErrorInvalidValue);
  const int run = repro::run_len(d);
  const int vec = d % run == 0 && aligned16(x) && aligned16(gumbel) &&
                  aligned16(mask);
  const int threads = repro::row_threads(d, run);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gumbel);
  const int* mm = static_cast<const int*>(m);
  uint8_t* out = static_cast<uint8_t*>(mask);
  if (run == repro::kRunNarrow)
    randtopk_mask_kernel<512, repro::kRunNarrow>
        <<<rows, threads, 0, s>>>(x, is_bf16, g, mm, d, k, vec, out);
  else if (threads <= 512)   // up to 128 registers a thread: x, noise runs
    randtopk_mask_kernel<512, repro::kRunWide>
        <<<rows, threads, 0, s>>>(x, is_bf16, g, mm, d, k, vec, out);
  else
    randtopk_mask_kernel<1024, repro::kRunWide>
        <<<rows, threads, 0, s>>>(x, is_bf16, g, mm, d, k, vec, out);
  return static_cast<int>(cudaGetLastError());
}
