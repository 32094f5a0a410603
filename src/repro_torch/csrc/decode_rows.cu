// Decode payload rows of any kind to dense rows, with an optional fused
// (d, p) cut-projection or an output slot map; and the bare sparse
// scatter.
//
// Replaces three Pallas kernels:
//   * `decode_rows_kernel` (src/repro/kernels/decode/kernel.py:181, bodies
//     `_make_rows_kernel` :145 and `_decode_block` :124): wire leaves of
//     any of six kinds -> dense f32 rows, optionally times a (d, p) matrix,
//     stored in the requested dtype;
//   * `decode_to_slots_kernel` (src/repro/kernels/decode/kernel.py:224):
//     the serving flush's decode, row i written in place into
//     xbuf[slots[i]] in xbuf's dtype (the Pallas kernel scalar-prefetches
//     the slot ids into its output index map); launched here as
//     `decode_to_slots`, the same two kernels with a slot map;
//   * `scatter_rows_kernel` (src/repro/kernels/randtopk/kernel.py:199, body
//     `_scatter_rows_kernel` :100): (values, indices) -> dense rows in the
//     values' dtype, duplicates summed in f32 — the sparse branch of the
//     decode without the projection, launched here as `scatter_rows`, which
//     runs the sparse decode's kernel with the values' dtype as the output's.
// The Pallas kernels place each of the k support values by a k-step
// compare-and-select over the whole row because the TPU has no scatter;
// here a block places them in shared memory.
//
// What bounds it on an H100: at the training shapes (1024 rows of d = 4096,
// k = 64, bf16 out) a sparse decode reads 512 KB of leaves and writes 8 MB
// of rows, 2.66 us at 3.35 TB/s: the store of the dense rows is the bound.
// A serving flush (4 rows of 4096, bf16 xbuf) reads about 2 KB and writes
// 32 KB, 0.01 us: there the launch and the work before the first store
// set the pace. Every block of the launch is resident at once, so whatever
// a block does before its stores (the leaf loads' latency, zeroing,
// barriers) adds to the store time instead of hiding under it. The design
// writes each output element exactly once, as 16-byte vectors, and keeps
// the work before the stores small:
//   * dense, slice and quant need no scatter (`decode_rows_flat_kernel`):
//     no shared memory and no barrier; each thread takes 8 consecutive
//     elements of the flat (rows, d) output, converts or dequantizes them
//     in registers from 16-byte loads of the values or codes (the slice's
//     k-wide rows element by element), and stores them as one 16-byte bf16
//     vector or two f32 ones. Dequantization is `repro::dequant`, each
//     operation rounded on its own, as the plain version: exact;
//   * sparse, sparse_quant and mask (`decode_rows_scatter_kernel`) place
//     their values in f32 in shared memory, at most 16 KB of rows per
//     block (one row at d = 4096, so 1024 blocks), and mark each placed
//     position in a bitmap. Only marked positions are ever written in
//     shared memory, so nothing is zeroed but the bitmap (512 bytes per
//     row of 4096), and the store (`store_hits`) reads the bitmap and
//     writes zeros where no bit is set: the 32 KB zeroing and read-back of
//     a dense shared row per block are gone. Sparse kinds: the first
//     value to mark a position (a shared atomicOr on the bitmap) stores
//     0 + v there, and only duplicates are added, with shared atomics,
//     after a barrier that a block without duplicates skips (duplicates
//     sum in f32; indices outside [0, d) are dropped, as no Pallas lane
//     matches them). A duplicate whose value is a zero is dropped too:
//     0 + v is never -0.0, nor is any sum of such, so adding a +-0.0
//     leaves every position as it is. That keeps a serving flush's pad
//     rows (k zero values at index 0, k - 1 duplicates) off the duplicate
//     path and its barrier. Each thread's first index
//     and value are loaded before the bitmap is zeroed, so their latency
//     overlaps it. A thread records its duplicates in 64 bits, which holds
//     while k <= d; a block with more values than that (k > d, which the
//     wire never sends) zeroes its rows and adds every value. Mask: a block
//     scan of the words'
//     popcounts (`block_excl_sum`) gives each set bit its value slot; set
//     bits past k stay unmarked, so 0. A block's rows go out as one run,
//     16-byte vectors from the first 16-byte boundary (a row that starts
//     off one, as at d = 70, stores its head element by element).
// With a slot map (`decode_to_slots`), row r goes to xbuf + slots[r] * d
// instead of out + r * d, and a slot outside [0, cap1) is skipped: the
// flat kernel takes 16-byte vectors only when d is a multiple of 8, so no
// vector spans two rows, and the scatter kernel stores each of its rows
// at its own slot. The serve pads a flush to its bucket with rows of zero
// leaves aimed at the scratch slot; several such rows write the same
// zeros to that row at once, a race with one outcome, as the reference's
// kernel has it.
// With a projection, the decoded f32 rows go to a scratch buffer and a
// second kernel multiplies them by w: a plain shared-memory tiled f32
// product (64 x 64 output tile per block of 256 threads, 4 x 4 outputs per
// thread, 16-deep k tiles), bound by f32 operations (2 * rows * d * p
// against 67 TFLOP/s) at any real width. It is right, not fast: no tensor
// cores, since the reference's epilogue is an f32 product.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxD = 16384;
constexpr int kHitFloats = 4096;              // decode: 16 KB of rows
constexpr int kMaxRows = 8;                   // rows per block, at most
constexpr int kVec = 8;                       // elements per flat vector
constexpr long long kMaxFlatBlocks = 8192;    // grid-stride beyond this
constexpr int kBM = 64, kBN = 64, kBK = 16;   // projection tiles

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Zero n floats of shared memory from `buf` (16-byte aligned when n is a
// multiple of 4): 16-byte stores, the rest one float at a time.
__device__ __forceinline__ void zero_shared(float* buf, int n) {
  float4* b4 = reinterpret_cast<float4*>(buf);
  for (int i = threadIdx.x; i < n / 4; i += blockDim.x)
    b4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = n / 4 * 4 + threadIdx.x; i < n; i += blockDim.x) buf[i] = 0.f;
}

__device__ __forceinline__ void store_vec(float* o, const float* f) {
  float4* p = reinterpret_cast<float4*>(o);
  p[0] = make_float4(f[0], f[1], f[2], f[3]);
  p[1] = make_float4(f[4], f[5], f[6], f[7]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* o, const float* f) {
  *reinterpret_cast<uint4*>(o) = repro::pack_bf16x8(f);
}

// Where element e of the flat (rows, d) decode goes: out + e, or with a
// slot map xbuf + slots[e / d] * d + e % d, null for a slot outside
// [0, cap1).
struct Dest {
  const int* slots;
  int cap1;

  template <typename T>
  __device__ __forceinline__ T* at(T* out, long long e, int d) const {
    if (slots == nullptr) return out + e;
    const long long r = e / d;
    const int s = slots[r];
    if (s < 0 || s >= cap1) return nullptr;
    return out + static_cast<long long>(s) * d + (e - r * d);
  }
};

// Dense, slice and quant rows: element e of the flat (rows, d) output from
// its own leaf element. With `vec` (out and, for dense and quant, the
// values or codes start 16-byte aligned; with a slot map also d a
// multiple of 8), 8 consecutive elements per thread per step, from
// 16-byte loads, stored as 16-byte vectors; one element at a time for the
// tail past the last whole vector, and for everything without `vec`.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_rows_flat_kernel(long long total, int d, int kind, int k,
                        const void* values, int vals_bf16,
                        const float* header, T* out, int vec, Dest dst) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t0 =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int* codes = static_cast<const int*>(values);
  const long long nvec = vec ? total / kVec : 0;
  for (long long q = t0; q < nvec; q += stride) {
    const long long e = q * kVec;
    T* o = dst.at(out, e, d);                   // its load issues first
    float f[kVec];
    if (kind == repro::kDense) {
      if (vals_bf16) {
        const uint4 u = *reinterpret_cast<const uint4*>(
            static_cast<const __nv_bfloat16*>(values) + e);
        const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          f[2 * j] = __uint_as_float(w[j] << 16);
          f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
        }
      } else {
        const float4* p = reinterpret_cast<const float4*>(
            static_cast<const float*>(values) + e);
        const float4 a = p[0], b = p[1];
        f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
        f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
      }
    } else {
      long long r = e / d;
      int c = static_cast<int>(e - r * d);
      if (kind == repro::kQuant) {
        const int4* p = reinterpret_cast<const int4*>(codes + e);
        const int4 a = p[0], b = p[1];
        const int cv[kVec] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
        float lo = header[r * 2], step = header[r * 2 + 1];
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          if (c == d) {                         // the next row begins
            c = 0;
            ++r;
            lo = header[r * 2];
            step = header[r * 2 + 1];
          }
          f[j] = repro::dequant(cv[j], lo, step);
          ++c;
        }
      } else {                                  // slice
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          if (c == d) {
            c = 0;
            ++r;
          }
          f[j] = c < k ? repro::load_f(values, vals_bf16, r * k + c) : 0.f;
          ++c;
        }
      }
    }
    if (o != nullptr) store_vec(o, f);
  }
  for (long long e = nvec * kVec + t0; e < total; e += stride) {
    T* o = dst.at(out, e, d);
    if (o == nullptr) continue;
    const long long r = e / d;
    const int c = static_cast<int>(e - r * d);
    float v;
    if (kind == repro::kDense)
      v = repro::load_f(values, vals_bf16, e);
    else if (kind == repro::kQuant)
      v = repro::dequant(codes[e], header[r * 2], header[r * 2 + 1]);
    else
      v = c < k ? repro::load_f(values, vals_bf16, r * k + c) : 0.f;
    repro::store_one(o, v);
  }
}

// Value j of the block's sparse leaf run (rows from row0, k per row): the
// value itself, or the dequantized code of sparse_quant.
__device__ __forceinline__ float sparse_value(int kind, const void* values,
                                              int vals_bf16,
                                              const float* header,
                                              long long row0, int k, int j) {
  const long long at = row0 * k + j;
  if (kind == repro::kSparse) return repro::load_f(values, vals_bf16, at);
  const long long r = row0 + j / k;
  return repro::dequant(static_cast<const int*>(values)[at], header[r * 2],
                        header[r * 2 + 1]);
}

// Bits [i, i + V) of the bitmap `bm` (V <= 32), bit q of the result for
// element i + q. Reads bm[i / 32 + 1] when the run crosses a word.
template <int V>
__device__ __forceinline__ unsigned hit_bits(const unsigned* bm, int i) {
  const int sh = i & 31;
  unsigned b = bm[i >> 5] >> sh;
  if (sh + V > 32) b |= bm[(i >> 5) + 1] << (32 - sh);
  return V == 32 ? b : b & ((1u << V) - 1u);
}

// Store n elements to `out` (T = float, or bf16 rounded to nearest):
// element i is `vals[i]` where bit b0 + i of `bm` is set, else 0. Runs of
// 8 elements (one 16-byte bf16 vector or two f32 ones) from the first
// 16-byte boundary of `out`, single elements before it and after the last
// whole run; `vals` is read only at set bits, so it needs no zeroing.
template <typename T>
__device__ __forceinline__ void store_hits(const float* vals,
                                           const unsigned* bm, int b0,
                                           int n, T* out) {
  constexpr int V = kVec;
  constexpr int A = 16 / sizeof(T);               // elements per 16 bytes
  const int mis = static_cast<int>(
      (reinterpret_cast<uintptr_t>(out) / sizeof(T)) % A);
  const int head = min(n, mis ? A - mis : 0);
  const int nv = (n - head) / V;
  for (int i = threadIdx.x; i < head; i += blockDim.x)
    repro::store_one(out + i, hit_bits<1>(bm, b0 + i) ? vals[i] : 0.f);
  for (int c = threadIdx.x; c < nv; c += blockDim.x) {
    const int i = head + c * V;
    const unsigned bits = hit_bits<V>(bm, b0 + i);
    float f[V];
#pragma unroll
    for (int q = 0; q < V; ++q) f[q] = (bits >> q) & 1u ? vals[i + q] : 0.f;
    store_vec(out + i, f);
  }
  for (int i = head + nv * V + threadIdx.x; i < n; i += blockDim.x)
    repro::store_one(out + i, hit_bits<1>(bm, b0 + i) ? vals[i] : 0.f);
}

// Store a block's nr rows of d from shared memory (`store_hits`): as one
// run at out + row0 * d, or with a slot map each row r at its own
// xbuf + slots[row0 + r] * d (`slot0` is the first row's, loaded early),
// a slot outside [0, cap1) skipped.
template <typename T>
__device__ __forceinline__ void store_rows(const float* buf,
                                           const unsigned* bm, int nr,
                                           int d, T* out, long long row0,
                                           const Dest& dst, int slot0) {
  if (dst.slots == nullptr) {
    store_hits(buf, bm, 0, nr * d, out + row0 * d);
    return;
  }
  for (int r = 0; r < nr; ++r) {
    const int s = r == 0 ? slot0 : dst.slots[row0 + r];
    if (s >= 0 && s < dst.cap1)
      store_hits(buf + r * d, bm, r * d, d,
                 out + static_cast<long long>(s) * d);
  }
}

// Sparse, sparse_quant and mask rows [blockIdx.x * R, + R): the values
// land in f32 in shared memory (R * d floats) and a bitmap marks where;
// only the marked positions are ever written in shared memory, and the
// store writes every output element once (`store_hits`).
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_rows_scatter_kernel(int rows, int d, int kind, int k, int R,
                           const void* values, int vals_bf16,
                           const int* indices, const float* header, T* out,
                           Dest dst) {
  extern __shared__ float4 rows_buf[];
  float* buf = reinterpret_cast<float*>(rows_buf);
  __shared__ unsigned bm[kMaxD / 32 + 1];
  __shared__ int warp_sums[33];
  __shared__ int row_first[kMaxRows];   // scan value at each row's 1st word
  __shared__ int any_dup;               // a nonzero value repeats an index
  const long long row0 = static_cast<long long>(blockIdx.x) * R;
  const int slot0 = dst.slots != nullptr ? dst.slots[row0] : 0;
  const int nr = static_cast<int>(min(static_cast<long long>(R),
                                      rows - row0));
  const int n = nr * d;
  if (kind == repro::kMask) {
    const int nw = (d + 31) >> 5;
    const int n_words = nr * nw;
    const unsigned* words =
        reinterpret_cast<const unsigned*>(indices) + row0 * nw;
    const unsigned tail = (d & 31) ? (1u << (d & 31)) - 1u : ~0u;
    const unsigned first = threadIdx.x < n_words ? words[threadIdx.x] : 0u;
    for (int w = threadIdx.x; w <= (n >> 5); w += blockDim.x) bm[w] = 0u;
    // the scan's barriers order the zeroing before the first atomicOr
    int running = 0;
    for (int base = 0; base < n_words; base += blockDim.x) {
      const int w = base + threadIdx.x;
      unsigned word = base == 0 ? first : (w < n_words ? words[w] : 0u);
      const int r = w / nw, c = w - r * nw;
      if (c == nw - 1) word &= tail;            // lanes >= d do not count
      int total;
      const int before = running + repro::block_excl_sum(__popc(word),
                                                         warp_sums, &total);
      if (w < n_words && c == 0) row_first[r] = before;
      __syncthreads();
      if (w < n_words) {
        int slot = before - row_first[r];       // value slot of 1st set bit
        const long long vrow = (row0 + r) * k;
        while (word != 0u) {
          const int b = __ffs(word) - 1;
          word &= word - 1u;
          if (slot < k) {
            const int at = r * d + c * 32 + b;
            buf[at] = repro::load_f(values, vals_bf16, vrow + slot);
            atomicOr(&bm[at >> 5], 1u << (at & 31));
          }
          ++slot;
        }
      }
      running += total;
    }
  } else {
    const int n_vals = nr * k;
    const int* idx = indices + row0 * k;
    if (n_vals > 64 * static_cast<int>(blockDim.x)) {
      // more values a thread than `dups` has bits (k > d): every position
      // marked, the rows zeroed, and every value added
      zero_shared(buf, n);
      for (int w = threadIdx.x; w <= (n >> 5); w += blockDim.x) bm[w] = ~0u;
      __syncthreads();
      for (int j = threadIdx.x; j < n_vals; j += blockDim.x) {
        const int at = idx[j];
        if (at >= 0 && at < d)
          atomicAdd(&buf[(j / k) * d + at],
                    sparse_value(kind, values, vals_bf16, header, row0, k, j));
      }
      __syncthreads();
      store_rows(buf, bm, nr, d, out, row0, dst, slot0);
      return;
    }
    // each thread's first value and index stay in registers from before
    // the zeroing on; the first value to reach a position stores 0 + v
    // (what an add into a zeroed row gives, -0 included), and the rest at
    // that position (duplicates) are added after a barrier, but for those
    // whose value is a zero, which would change nothing. A thread takes at
    // most 64 values here, one bit each in `dups`.
    int at0 = -1;
    float v0 = 0.f;
    if (threadIdx.x < n_vals) {
      at0 = idx[threadIdx.x];
      v0 = sparse_value(kind, values, vals_bf16, header, row0, k,
                        threadIdx.x);
    }
    for (int w = threadIdx.x; w <= (n >> 5); w += blockDim.x) bm[w] = 0u;
    if (threadIdx.x == 0) any_dup = 0;
    __syncthreads();
    unsigned long long dups = 0ull;
    int it = 0;
    for (int j = threadIdx.x; j < n_vals; j += blockDim.x, ++it) {
      const int at = it == 0 ? at0 : idx[j];
      if (at < 0 || at >= d) continue;          // dropped, as no lane matches
      const int pos = (j / k) * d + at;
      const unsigned bit = 1u << (pos & 31);
      const float v = it == 0 ? v0
                              : sparse_value(kind, values, vals_bf16,
                                             header, row0, k, j);
      if (!(atomicOr(&bm[pos >> 5], bit) & bit))
        buf[pos] = __fadd_rn(0.f, v);
      else if (v != 0.f)
        dups |= 1ull << it;
    }
    if (dups != 0ull) any_dup = 1;
    __syncthreads();
    if (!any_dup) {       // the common case: no nonzero value repeats
      store_rows(buf, bm, nr, d, out, row0, dst, slot0);
      return;
    }
    for (; dups != 0ull; dups &= dups - 1ull) {
      const int i = __ffsll(static_cast<long long>(dups)) - 1;
      const int j = threadIdx.x + i * blockDim.x;
      atomicAdd(&buf[(j / k) * d + (i == 0 ? at0 : idx[j])],
                i == 0 ? v0 : sparse_value(kind, values, vals_bf16, header,
                                           row0, k, j));
    }
  }
  __syncthreads();
  store_rows(buf, bm, nr, d, out, row0, dst, slot0);
}

// Decode `rows` payload rows into out (rows, d), or with `dst.slots` into
// the rows of out (cap1, d) the slot map names.
template <typename T>
int launch_decode(const void* values, int vals_bf16, const void* indices,
                  const void* header, int rows, int d, int kind, int k,
                  T* out, Dest dst, cudaStream_t s) {
  const float* hdr = static_cast<const float*>(header);
  if (kind == repro::kDense || kind == repro::kSlice ||
      kind == repro::kQuant) {
    const long long total = static_cast<long long>(rows) * d;
    const int vec = aligned16(out) &&
                    (kind == repro::kSlice || aligned16(values)) &&
                    (dst.slots == nullptr || d % kVec == 0);
    const long long work = vec ? (total + kVec - 1) / kVec : total;
    const long long blocks =
        min((work + kThreads - 1) / kThreads, kMaxFlatBlocks);
    decode_rows_flat_kernel<T><<<static_cast<int>(blocks), kThreads, 0, s>>>(
        total, d, kind, k, values, vals_bf16, hdr, out, vec, dst);
    return static_cast<int>(cudaGetLastError());
  }
  static bool attr_set = false;
  if (!attr_set) {
    cudaFuncSetAttribute(decode_rows_scatter_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kMaxD * static_cast<int>(sizeof(float)));
    attr_set = true;
  }
  const int R = max(1, min(kMaxRows, kHitFloats / d));
  decode_rows_scatter_kernel<T><<<(rows + R - 1) / R, kThreads,
                                  static_cast<size_t>(R) * d * sizeof(float),
                                  s>>>(
      rows, d, kind, k, R, values, vals_bf16,
      static_cast<const int*>(indices), hdr, out, dst);
  return static_cast<int>(cudaGetLastError());
}

// out (M, N) = a (M, K) @ w (K, N), all f32 in, f32 accumulate, stored in
// f32 or bf16. Block (blockIdx.y, blockIdx.x) owns a kBM x kBN tile;
// thread (ty, tx) of a 16 x 16 grid its 4 x 4 outputs.
__global__ void __launch_bounds__(kThreads)
project_rows_kernel(const float* a, const float* w, void* out, int out_bf16,
                    int M, int K, int N) {
  __shared__ float as[kBK][kBM + 4];            // a tile, transposed
  __shared__ float ws[kBK][kBN + 4];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int e = threadIdx.x; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, c = e % kBK;
      const int gr = row0 + r, gc = k0 + c;
      as[c][r] = (gr < M && gc < K)
                     ? a[static_cast<long long>(gr) * K + gc] : 0.f;
    }
    for (int e = threadIdx.x; e < kBK * kBN; e += kThreads) {
      const int r = e / kBN, c = e % kBN;
      const int gr = k0 + r, gc = col0 + c;
      ws[r][c] = (gr < K && gc < N)
                     ? w[static_cast<long long>(gr) * N + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = ws[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty * 4 + i;
    if (gr >= M) continue;
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + tx * 4 + j;
      if (gc >= N) continue;
      const long long at = static_cast<long long>(gr) * N + gc;
      if (out_bf16)
        static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16_rn(acc[i][j]);
      else
        static_cast<float*>(out)[at] = acc[i][j];
    }
  }
}

}  // namespace

// Leaves of the kind, leading dim rows: values f32 or bf16 (`vals_bf16`;
// dense/slice/sparse/mask) or int32 codes (quant kinds), indices int32
// (sparse kinds) or u32 mask words, header (rows, 2) f32 (quant kinds).
// out: (rows, d) in f32 or bf16 (`out_bf16`). Requires 1 <= d <= 16384.
// Returns cudaGetLastError() after the launch.
extern "C" int decode_rows(const void* values, int vals_bf16,
                           const void* indices, const void* header, int rows,
                           int d, int kind, int k, void* out, int out_bf16,
                           void* stream) {
  if (d < 1 || d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dest dst{nullptr, rows};
  return out_bf16 ? launch_decode(values, vals_bf16, indices, header, rows,
                                  d, kind, k,
                                  static_cast<__nv_bfloat16*>(out), dst, s)
                  : launch_decode(values, vals_bf16, indices, header, rows,
                                  d, kind, k, static_cast<float*>(out), dst,
                                  s);
}

// xbuf: (cap1, d) f32/bf16 (`is_bf16`), written in place: row i of the
// flush (n rows) goes to xbuf[slots[i]], a slot outside [0, cap1) is
// skipped, untouched rows keep their contents. slots: (n,) int32; leaves
// of the kind, leading dim n: values f32, or int32 codes (quant kinds),
// indices int32 (sparse kinds) or u32 mask words, header (n, 2) f32 (quant
// kinds). Requires 1 <= d <= 16384.
extern "C" int decode_to_slots(void* xbuf, int is_bf16, int cap1, int d,
                               const void* slots, int n, int kind, int k,
                               const void* values, const void* indices,
                               const void* header, void* stream) {
  if (d < 1 || d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dest dst{static_cast<const int*>(slots), cap1};
  return is_bf16 ? launch_decode(values, 0, indices, header, n, d, kind, k,
                                 static_cast<__nv_bfloat16*>(xbuf), dst, s)
                 : launch_decode(values, 0, indices, header, n, d, kind, k,
                                 static_cast<float*>(xbuf), dst, s);
}

// `decode_rows` with the cut-projection epilogue: the f32 rows go to
// `scratch` (rows, d), then out (rows, p) = scratch @ w, w (d, p) f32, in
// f32 or bf16 (`out_bf16`).
extern "C" int decode_rows_project(const void* values, int vals_bf16,
                                   const void* indices, const void* header,
                                   int rows, int d, int kind, int k,
                                   const void* w, int p, void* scratch,
                                   void* out, int out_bf16, void* stream) {
  if (d < 1 || d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_decode(values, vals_bf16, indices, header, rows, d,
                                kind, k, static_cast<float*>(scratch),
                                Dest{nullptr, rows}, s);
  if (err != 0) return err;
  const dim3 grid((p + kBN - 1) / kBN, (rows + kBM - 1) / kBM);
  project_rows_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(scratch), static_cast<const float*>(w), out,
      out_bf16, rows, d, p);
  return static_cast<int>(cudaGetLastError());
}

// values: (rows, k) f32 or bf16 (`vals_bf16`); indices: (rows, k) int32;
// out: (rows, d) in the values' dtype, zeros off the support, duplicate
// indices summed in f32, indices outside [0, d) dropped: the sparse decode
// without a header. Requires d <= 16384.
extern "C" int scatter_rows(const void* values, int vals_bf16,
                            const void* indices, int rows, int d, int k,
                            void* out, void* stream) {
  return decode_rows(values, vals_bf16, indices, nullptr, rows, d,
                     repro::kSparse, k, out, vals_bf16, stream);
}
