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

__device__ __forceinline__ void store_one(float* o, float v) { *o = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}

// Two floats rounded to nearest bf16, a in the low half of the word.
__device__ __forceinline__ unsigned pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h =
      __halves2bfloat162(__float2bfloat16_rn(a), __float2bfloat16_rn(b));
  return *reinterpret_cast<const unsigned*>(&h);
}

// 8 floats rounded to nearest bf16, packed in order into one 16-byte
// vector.
__device__ __forceinline__ uint4 pack_bf16x8(const float* f) {
  return make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                    pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
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
// the key of +0.0, since the two compare equal. NaN is out of scope.
__device__ __forceinline__ unsigned float_key(float f) {
  unsigned u = __float_as_uint(f);
  if ((u << 1) == 0u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
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

// ---------------------------------------------------------------------------
// Row teams and the exact top-k select of the selection kernels
// ---------------------------------------------------------------------------

// Consecutive row elements a thread owns (its run), chosen from d so that
// a warp is full: 4 up to d = 512 (a 128-wide row is one warp of 4 each),
// else 16, so d <= 16384 fits one block of 1024 threads. A row of d
// elements is held by ceil(d / run) threads, rounded up to whole warps, its
// values in registers. Kernels are instantiated for both (`R` below).
constexpr int kRunNarrow = 4;
constexpr int kRunWide = 16;
constexpr int kMaxD = 16384;
constexpr int kAll = 1 << 30;      // a `need` that admits a whole bucket

__host__ __device__ inline int run_len(int d) {
  return d <= 512 ? kRunNarrow : kRunWide;
}

// Threads a row of d elements takes with runs of `run`: whole warps, 32 to
// 1024.
__host__ __device__ inline int row_threads(int d, int run) {
  const int runs = (d + run - 1) / run;
  return runs <= 32 ? 32 : (runs + 31) / 32 * 32;
}

// Shared scratch of one team: the select's histogram and verdict, and the
// per-warp partials of its scans (`warp_sums`) and min/max (`red`).
struct alignas(16) TeamScratch {
  int hist[2][256];             // one pass counts while the other is zeroed
  int warp_sums[33];
  unsigned red[64];
  unsigned prefix;
  int remaining;
  int ties;
};

// A team: `size` threads (whole warps) of one block that work on one row
// together; team `id` is threads [id * size, (id + 1) * size). It syncs
// with __syncwarp when it is one warp, __syncthreads when it is the
// block, else on its own named barrier 1 + id (so at most 15 such teams).
struct Team {
  int id;
  int size;
  int rank;                       // thread index within the team
  TeamScratch* s;

  __device__ __forceinline__ void sync() const {
    if (size == 32) {
      __syncwarp();
    } else if (size == static_cast<int>(blockDim.x)) {
      __syncthreads();
    } else {
      asm volatile("bar.sync %0, %1;" ::"r"(id + 1), "r"(size) : "memory");
    }
  }
};

// Team-wide exclusive prefix sum of `v` in rank order; the team total
// lands in `*total`. Every thread of the team must call it; on return the
// team's `warp_sums` are free again.
__device__ __forceinline__ int team_excl_sum(int v, const Team& t,
                                             int* total) {
  const int lane = t.rank & 31;
  const int warp = t.rank >> 5;
  const int n_warps = t.size >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += up;
  }
  if (n_warps == 1) {
    *total = __shfl_sync(kFull, incl, 31);
    return incl - v;
  }
  int* ws = t.s->warp_sums;
  if (lane == 31) ws[warp] = incl;
  t.sync();
  if (warp == 0) {
    int w = lane < n_warps ? ws[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += up;
    }
    if (lane < n_warps) ws[lane] = w;             // inclusive per warp
    if (lane == 31) ws[32] = w;                   // team total
  }
  t.sync();
  const int before = (warp ? ws[warp - 1] : 0) + incl - v;
  *total = ws[32];
  t.sync();
  return before;
}

// Total-order key of a float, for min and max: a < b iff order_key(a) <
// order_key(b), and -0.0 sorts just below +0.0, as XLA's min and max order
// them (so a row whose least value is a zero reports -0.0 when it holds
// one). `order_val` inverts it. NaN is out of scope.
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float order_val(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// Fold the `order_key`s of a run's `valid` lanes into a min and a max.
template <int R>
__device__ __forceinline__ void run_minmax(const float* v, unsigned valid,
                                           unsigned& mn, unsigned& mx) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    if ((valid >> j) & 1u) {
      const unsigned o = order_key(v[j]);
      mn = min(mn, o);
      mx = max(mx, o);
    }
  }
}

// Team-wide min and max of `order_key`s (every thread gets both, as
// floats).
__device__ __forceinline__ void team_minmax(unsigned mn, unsigned mx,
                                            const Team& t, float* lo,
                                            float* hi) {
  mn = __reduce_min_sync(kFull, mn);
  mx = __reduce_max_sync(kFull, mx);
  const int n_warps = t.size >> 5;
  if (n_warps > 1) {
    const int lane = t.rank & 31;
    const int warp = t.rank >> 5;
    unsigned* red = t.s->red;
    if (lane == 0) {
      red[warp] = mn;
      red[32 + warp] = mx;
    }
    t.sync();
    if (warp == 0) {
      mn = __reduce_min_sync(kFull, lane < n_warps ? red[lane] : ~0u);
      mx = __reduce_max_sync(kFull, lane < n_warps ? red[32 + lane] : 0u);
      if (lane == 0) {
        red[0] = mn;
        red[32] = mx;
      }
    }
    t.sync();
    mn = red[0];
    mx = red[32];
    t.sync();
  }
  *lo = order_val(mn);
  *hi = order_val(mx);
}

// Team-wide min of an unsigned value (every thread gets it).
__device__ __forceinline__ unsigned team_min_u32(unsigned v, const Team& t) {
  v = __reduce_min_sync(kFull, v);
  const int n_warps = t.size >> 5;
  if (n_warps == 1) return v;
  const int lane = t.rank & 31;
  const int warp = t.rank >> 5;
  unsigned* ws = reinterpret_cast<unsigned*>(t.s->warp_sums);
  if (lane == 0) ws[warp] = v;
  t.sync();
  if (warp == 0) {
    v = __reduce_min_sync(kFull, lane < n_warps ? ws[lane] : ~0u);
    if (lane == 0) ws[32] = v;
  }
  t.sync();
  v = ws[32];
  t.sync();
  return v;
}

// Lanes [c0, c0 + R) of a row of d that lie inside it, as run bits.
template <int R>
__device__ __forceinline__ unsigned run_valid(int c0, int d) {
  if (c0 >= d) return 0u;
  return c0 + R <= d ? (1u << R) - 1u : (1u << (d - c0)) - 1u;
}

// A thread's run of row elements [c0, c0 + R) as f32 (a bf16 is the top
// half of its f32), and a bit per element whose mask byte is nonzero when
// `mask` is given. Elements at or past d read as 0, their bit clear.
// `vec`: d % R == 0 and x (and mask) start 16-byte aligned, so a run is
// whole vectors (R / 4 f32 or R / 8 bf16 16-byte loads; 8 bytes of bf16
// and 4 mask bytes at R = 4).
template <int R>
struct Run {
  float v[R];
  unsigned bits;
};

template <int R>
__device__ __forceinline__ void load_run(const void* x, int is_bf16,
                                         const uint8_t* mask,
                                         long long row_off, int c0, int d,
                                         bool vec, Run<R>& r) {
  r.bits = 0u;
  if (!vec) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int c = c0 + j;
      const bool in = c < d;
      r.v[j] = in ? load_f(x, is_bf16, row_off + c) : 0.f;
      if (mask != nullptr && in && mask[row_off + c] != 0) r.bits |= 1u << j;
    }
    return;
  }
  if (c0 >= d) {
#pragma unroll
    for (int j = 0; j < R; ++j) r.v[j] = 0.f;
    return;
  }
  if (is_bf16) {
    const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(x) +
                             row_off + c0;
    unsigned w[R / 2];
    if constexpr (R % 8 == 0) {
#pragma unroll
      for (int q = 0; q < R / 8; ++q) {
        const uint4 u = reinterpret_cast<const uint4*>(p)[q];
        w[4 * q] = u.x;
        w[4 * q + 1] = u.y;
        w[4 * q + 2] = u.z;
        w[4 * q + 3] = u.w;
      }
    } else {
      static_assert(R == 4, "a run is 4 or a multiple of 8 elements");
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      w[0] = u.x;
      w[1] = u.y;
    }
#pragma unroll
    for (int j = 0; j < R / 2; ++j) {
      r.v[2 * j] = __uint_as_float(w[j] << 16);
      r.v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  } else {
    const float4* p = reinterpret_cast<const float4*>(
        static_cast<const float*>(x) + row_off + c0);
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const float4 f = p[q];
      r.v[4 * q] = f.x;
      r.v[4 * q + 1] = f.y;
      r.v[4 * q + 2] = f.z;
      r.v[4 * q + 3] = f.w;
    }
  }
  if (mask != nullptr) {
    const unsigned* m = reinterpret_cast<const unsigned*>(mask + row_off + c0);
#pragma unroll
    for (int j = 0; j < R; ++j)
      if ((m[j >> 2] >> ((j & 3) * 8)) & 0xffu) r.bits |= 1u << j;
  }
}

// A run's bits as bytes 0/1 at dst[0, R) (R / 4 aligned u32 stores, or
// one 16-byte store at R = 16) when `vec`, else one byte at a time below
// `n`.
template <int R>
__device__ __forceinline__ void store_bytes(uint8_t* dst, unsigned bits,
                                            bool vec, int n) {
  if (!vec) {
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (j < n) dst[j] = (bits >> j) & 1u;
    return;
  }
  if (n <= 0) return;
  unsigned w[R / 4];
#pragma unroll
  for (int q = 0; q < R / 4; ++q) {
    w[q] = 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b) w[q] |= ((bits >> (4 * q + b)) & 1u) << (8 * b);
  }
  if constexpr (R == 16) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int q = 0; q < R / 4; ++q) reinterpret_cast<unsigned*>(dst)[q] = w[q];
  }
}

// The magnitude key of a value: the bit pattern of |v|, which orders like
// |v| (-0.0 becomes +0.0). A bf16 value's low 16 bits are zero, so its key
// is the top 15 bits: `mag_bits` = 15 (bf16) or 31 (f32) significant bits.
__device__ __forceinline__ unsigned mag_key(float v, int is_bf16) {
  const unsigned u = __float_as_uint(fabsf(v));
  return is_bf16 ? u >> 16 : u;
}

__device__ __forceinline__ int mag_bits(int is_bf16) {
  return is_bf16 ? 15 : 31;
}

// Where a select cut a team's keys: every key whose bits at and above `hi`
// exceed `prefix` (which is zero below `hi`) is in the top; of the keys
// equal to it there (the boundary bucket), the first `need` from the left
// are. `ties` is false when the bucket is admitted whole (`need` is then
// its size).
struct Cut {
  unsigned prefix;
  int hi;
  int need;
  bool ties;
};

// The EXACT boundary of the `target` largest keys (1 <= target <= the
// number of valid keys) among the team's runs of R: `key(j)` is the
// thread's j-th key (`kbits` significant bits, at most 32), `valid` its
// run bits in the set. Radix passes from the top, 8 bits each (the last
// takes what is left: 2 passes for bf16 magnitudes, 4 for f32): a
// 256-bucket shared histogram of the keys still in the running, then one
// warp finds the bucket that holds the target by a suffix scan while the
// rest of the team zeroes the second histogram for the next pass (two
// barriers a pass). The passes stop early
// when that bucket is taken whole (its count equals the remaining need),
// since then no tie is left to break. The keys stay in registers; a key
// that is out of the running (not in the prefix found so far) costs a
// compare and no shared-memory access. Every thread of the team must call
// it; the scratch's `warp_sums` and `red` are not touched, and a second
// select may follow at once.
template <int R, class KeyOf>
__device__ __forceinline__ Cut team_select(KeyOf key, unsigned valid,
                                           int kbits, int target,
                                           const Team& t) {
  TeamScratch* s = t.s;
  const int lane = t.rank & 31;
  unsigned prefix = 0u;
  int hi = kbits;
  int remaining = target;
  bool ties = true;
  int buf = 0;
  for (int b = t.rank; b < 256; b += t.size) s->hist[0][b] = 0;
  t.sync();
  while (hi > 0) {
    const int nb = hi < 8 ? hi : 8;
    const int shift = hi - nb;
    const unsigned fixed = hi >= 32 ? 0u : ~0u << hi;
    int* hist = s->hist[buf];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const unsigned kj = key(j);
      const bool in = ((valid >> j) & 1u) && (kj & fixed) == prefix;
      const unsigned b = (kj >> shift) & ((1u << nb) - 1u);
      if (in) atomicAdd(&hist[b], 1);
    }
    t.sync();
    if (t.rank < 32) {
      // lane l owns buckets [8l, 8l + 8), read as two 16-byte vectors;
      // suffix = count in lanes >= l
      const int4 lo4 = reinterpret_cast<const int4*>(hist)[2 * lane];
      const int4 hi4 = reinterpret_cast<const int4*>(hist)[2 * lane + 1];
      const int c[8] = {lo4.x, lo4.y, lo4.z, lo4.w,
                        hi4.x, hi4.y, hi4.z, hi4.w};
      int local = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) local += c[j];
      int suffix = local;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int down = __shfl_down_sync(kFull, suffix, o);
        if (lane + o < 32) suffix += down;
      }
      const int above = suffix - local;
      if (above < remaining && suffix >= remaining) {   // exactly one lane
        int cum = above;
        bool found = false;
#pragma unroll
        for (int j = 7; j >= 0; --j) {
          if (!found) {
            cum += c[j];
            if (cum >= remaining) {
              const int left = remaining - (cum - c[j]);
              s->prefix = prefix | (static_cast<unsigned>(lane * 8 + j)
                                    << shift);
              s->remaining = left;
              s->ties = c[j] > left;
              found = true;
            }
          }
        }
      }
    }
    // the rest of the team zeroes the other histogram for the next pass
    // (a one-warp team does it after its scan)
    if (t.size == 32 || t.rank >= 32) {
      int* next = s->hist[buf ^ 1];
      const int z = t.size == 32 ? 0 : 32;
      for (int b = t.rank - z; b < 256; b += t.size - z) next[b] = 0;
    }
    t.sync();
    prefix = s->prefix;
    remaining = s->remaining;
    ties = s->ties != 0;
    hi = shift;
    buf ^= 1;
    if (!ties) break;
  }
  return Cut{prefix, hi, remaining, ties};
}

// A thread's run split by a Cut: `gt` the keys above the boundary bucket,
// `eq` those inside it (both within `valid`).
template <int R, class KeyOf>
__device__ __forceinline__ void cut_bits(KeyOf key, unsigned valid,
                                         const Cut& c, unsigned* gt,
                                         unsigned* eq) {
  const unsigned hm = ~0u << c.hi;            // c.hi < 32
  unsigned g = 0u, e = 0u;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const unsigned kj = key(j) & hm;
    if (kj > c.prefix) g |= 1u << j;
    if (kj == c.prefix) e |= 1u << j;
  }
  *gt = g & valid;
  *eq = e & valid;
}

// The selected bits of a run: all of `gt`, and of `eq` those whose rank
// among the bucket's keys from the left (`eq_before` of them sit in
// earlier runs) is below `need`: the XLA tie rule.
template <int R>
__device__ __forceinline__ unsigned admit(unsigned gt, unsigned eq,
                                          int eq_before, int need) {
  unsigned sel = gt;
  int e = eq_before;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    if ((eq >> j) & 1u) {
      if (e < need) sel |= 1u << j;
      ++e;
    }
  }
  return sel;
}

// The words of a flat stream of `width`-bit values (value i at stream bits
// [i*width, (i+1)*width), bit j at bit j%32 of word j//32) that hold rows
// [r0, r1) of `per_row` values each: the rows start and end on a word
// boundary (the caller groups rows so they do), and a range that ends at
// the last row also writes the zero words up to ceil(rows * per_row / 32)
// * width. Thread `tid` of `nthreads` takes words tid, tid + nthreads, ...
// of the range, ORing together the at most ceil(32 / width) + 1 values of
// each: no atomics, no combining across threads, coalesced writes. The
// fused encode packs its block's rows with its block's threads (`vals`
// written by the block before a barrier, so plain coherent loads); the
// standalone `pack_bits` packs one row of n values with the whole grid.
__device__ __forceinline__ void pack_rows(const int* vals, long long per_row,
                                          int width, unsigned* out,
                                          long long r0, long long r1,
                                          long long rows, long long tid,
                                          long long nthreads) {
  const long long n = rows * per_row;
  const long long w0 = r0 * per_row * width / 32;
  const long long w1 = r1 == rows ? (n + 31) / 32 * width
                                  : r1 * per_row * width / 32;
  const unsigned vmask = width == 32 ? 0xffffffffu : (1u << width) - 1u;
  for (long long w = w0 + tid; w < w1; w += nthreads) {
    const long long lo_bit = w * 32;
    const long long first = lo_bit / width;
    const long long last = min((lo_bit + 31) / width, n - 1);
    unsigned word = 0u;
    for (long long i = first; i <= last; ++i) {
      const unsigned v = static_cast<unsigned>(vals[i]) & vmask;
      const long long s = i * width - lo_bit;       // -(width-1) .. 31
      word |= s >= 0 ? (v << s) : (v >> (-s));
    }
    out[w] = word;
  }
}

}  // namespace repro
