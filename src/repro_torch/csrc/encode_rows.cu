// Fused payload encode: activation rows [+ selection mask, or the row's
// own top-k] -> the wire leaves of any payload kind and, on request, the
// packed wire sections, in one launch.
//
// Replaces the Pallas kernel `encode_rows_kernel`
// (src/repro/kernels/encode/kernel.py:160, bodies `_encode_block` :113,
// `_gather_block` :51, `_quant_block` :93, `_mask_words_block` :75). The
// TPU version compacts the support with a log-step lane prefix sum and a
// k-step compare-and-select loop because it has no cheap gather/scatter.
// The `encode_sections` entry also does the work of `topk_mask_threshold`
// (src/repro/kernels/randtopk/kernel.py:133) and of `pack_bits_kernel`
// (src/repro/kernels/encode/kernel.py:236) inside the same launch, which
// the reference's jitted client step runs as three Pallas calls with no
// host dispatch between them.
//
// What bounds it on an H100: at serving shapes (one row of d = 4096 bf16,
// k = 64) it moves about 9 KB, a few ns of HBM time, so what sets the pace
// is latency: the host's launch, the dependent loads and the block's
// barriers. Three launches per served token (top-k mask, encode, bit-pack)
// cost three host wrappers; this kernel makes it one. The design:
//   * a row is held by a team of threads (`Team` in common.cuh), each
//     thread a run of consecutive elements in registers (vector loads
//     where the row is aligned): 4 up to d = 512, so a 128-wide row fills
//     one warp, else 16; x is read once whatever the kind;
//   * `select`: the row's exact top-k by |x| (`team_select`, the routine
//     of `topk_select.cu`: 2 radix passes for bf16), so no byte mask
//     reaches device memory; otherwise the mask bytes come in with x;
//   * one team scan (`team_excl_sum`) of two counts packed in one int,
//     the keys above the boundary bucket and those inside it, gives each
//     thread its first output slot under the XLA tie rule: slot = above
//     before it + min(inside before it, need);
//   * values, indices, codes and mask words are written from registers;
//     quant ranges are team min/max reductions of the same registers, on
//     total-order keys so that -0.0 is below +0.0 as in XLA's min;
//   * packing: row r's b-bit stream starts at bit r * k * b, so rows whose
//     streams share a u32 word go to one block (`group_rows`: the fewest
//     rows whose bits fill whole words, 32 at most); after a block
//     barrier each thread ORs together the values of whole output words
//     of its block's rows, read back from the leaves the block just wrote.
//     No word is written by two blocks, so no atomics and no zeroing.
//     Narrow rows run several teams per block (one warp each up to
//     d = 128).
// Rows that are not 16-byte aligned (d not a multiple of 16, or a pointer
// off a 16-byte boundary) load and store one element at a time.
// Inputs are f32 or bf16 (a bf16 is the top half of its f32); outputs are
// f32 values, int32 codes/indices and the u32 mask and stream words.
#include "common.cuh"

namespace {

struct EncodeArgs {
  const void* x;
  const uint8_t* mask;        // mask kinds without `select`, else null
  int is_bf16;
  int d;
  int rows;
  int kind;
  int k;
  int bits;
  int select;
  int vec;
  int idx_bits;               // index width on the wire
  int group_rows;             // rows a block encodes (packed words whole)
  int teams;                  // rows a block has in flight
  void* out0;                 // values | codes
  void* out1;                 // indices | mask words | quant header
  void* out2;                 // sparse_quant header
  unsigned* idx_words;        // the packed index stream, or null
  unsigned* code_words;       // the packed code stream, or null
};

// Codes of a run into codes[c0, c0 + R) below d: one 16-byte store per
// 4 codes when `vec` (then codes + c0 is 16-byte aligned).
template <int R>
__device__ __forceinline__ void store_codes(const repro::Run<R>& r, int c0,
                                            int d, bool vec, float lo,
                                            float step, float n_bins,
                                            int* codes) {
  int c[R];
#pragma unroll
  for (int j = 0; j < R; ++j)
    c[j] = repro::quant_code(r.v[j], lo, step, n_bins);
  if (vec) {
    if (c0 >= d) return;
    int4* p = reinterpret_cast<int4*>(codes + c0);
#pragma unroll
    for (int q = 0; q < R / 4; ++q)
      p[q] = make_int4(c[4 * q], c[4 * q + 1], c[4 * q + 2], c[4 * q + 3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < R; ++j)
    if (c0 + j < d) codes[c0 + j] = c[j];
}

// One row by one team: every thread of the team must call it. `a` is
// taken by value so that its fields are read from the kernel's parameter
// space, not from a per-thread copy. `kSelect`: the support is the row's
// own top-k (a separate instantiation, so a kernel given the mask carries
// no select code). `R`: the run a thread holds (`repro::run_len`).
template <bool kSelect, int R>
__device__ __forceinline__ void encode_row(const EncodeArgs a,
                                           long long row,
                                           const repro::Team& t) {
  const int d = a.d, k = a.k;
  const int c0 = t.rank * R;
  const bool vec = a.vec != 0;
  const unsigned valid = repro::run_valid<R>(c0, d);
  const float n_bins = static_cast<float>(1 << a.bits);
  repro::Run<R> r;
  repro::load_run<R>(a.x, a.is_bf16, a.mask, row * d, c0, d, vec, r);

  if (a.kind == repro::kDense || a.kind == repro::kSlice) {
    const int w = a.kind == repro::kDense ? d : k;
    float* o = static_cast<float*>(a.out0) + row * w;
    if (vec && a.kind == repro::kDense) {
      if (c0 >= d) return;
      float4* p = reinterpret_cast<float4*>(o + c0);
#pragma unroll
      for (int q = 0; q < R / 4; ++q)
        p[q] = make_float4(r.v[4 * q], r.v[4 * q + 1], r.v[4 * q + 2],
                           r.v[4 * q + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < R; ++j)
        if (c0 + j < w) o[c0 + j] = r.v[j];
    }
    return;
  }

  if (a.kind == repro::kQuant) {
    unsigned mn = ~0u, mx = 0u;
    repro::run_minmax<R>(r.v, valid, mn, mx);
    float lo, hi;
    repro::team_minmax(mn, mx, t, &lo, &hi);
    float step = __fdiv_rn(__fsub_rn(hi, lo), n_bins);
    if (step <= 0.f) step = 1.f;
    store_codes(r, c0, d, vec, lo, step, n_bins,
                static_cast<int*>(a.out0) + row * d);
    if (t.rank == 0) {
      static_cast<float*>(a.out1)[row * 2] = lo;
      static_cast<float*>(a.out1)[row * 2 + 1] = step;
    }
    return;
  }

  // sparse / sparse_quant / mask: the support, then its compaction in
  // index order
  unsigned gt = r.bits, eq = 0u;
  int need = 0;
  if (kSelect) {
    auto key = [&](int j) { return repro::mag_key(r.v[j], a.is_bf16); };
    const repro::Cut c = repro::team_select<R>(
        key, valid, repro::mag_bits(a.is_bf16), k, t);
    repro::cut_bits<R>(key, valid, c, &gt, &eq);
    need = c.ties ? c.need : repro::kAll;
  }
  int total;
  const int before = repro::team_excl_sum(__popc(gt) | (__popc(eq) << 16),
                                          t, &total);
  const int eq_before = before >> 16;
  const int pos = (before & 0xffff) + min(eq_before, need);
  const int count = (total & 0xffff) + min(total >> 16, need);
  const unsigned sel = repro::admit<R>(gt, eq, eq_before, need);

  const bool sq = a.kind == repro::kSparseQuant;
  float* vals = static_cast<float*>(a.out0) + row * k;
  int* idx = a.kind == repro::kMask ? nullptr
             : static_cast<int*>(a.out1) + row * k;
  int p = pos;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    if ((sel >> j) & 1u) {
      if (p < k) {
        if (!sq) vals[p] = r.v[j];
        if (idx != nullptr) idx[p] = c0 + j;
      }
      ++p;
    }
  }
  if (a.kind == repro::kMask) {
    // a word is the runs of 32 / R neighbouring threads, ORed across them
    // by shuffles; the first of them writes it
    constexpr int per = 32 / R;
    const int nw = (d + 31) >> 5;
    unsigned word = sel << (R * (t.rank % per));
#pragma unroll
    for (int o = 1; o < per; o <<= 1)
      word |= __shfl_xor_sync(repro::kFull, word, o);
    if (t.rank % per == 0 && (c0 >> 5) < nw)
      static_cast<unsigned*>(a.out1)[row * nw + (c0 >> 5)] = word;
  }
  for (int j = min(count, k) + t.rank; j < k; j += t.size) {
    if (!sq) vals[j] = 0.f;
    if (idx != nullptr) idx[j] = 0;
  }
  if (!sq) return;

  // sparse_quant: the range of the k gathered values (zeros past the
  // row's count), then their codes
  const unsigned zero = repro::order_key(0.f);
  unsigned mn = count < k ? zero : ~0u, mx = count < k ? zero : 0u;
  p = pos;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    if ((sel >> j) & 1u) {
      if (p < k) {
        const unsigned o = repro::order_key(r.v[j]);
        mn = min(mn, o);
        mx = max(mx, o);
      }
      ++p;
    }
  }
  float lo, hi;
  repro::team_minmax(mn, mx, t, &lo, &hi);
  const float step = hi > lo ? __fdiv_rn(__fsub_rn(hi, lo), n_bins) : 1.f;
  int* codes = static_cast<int*>(a.out0) + row * k;
  p = pos;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    if ((sel >> j) & 1u) {
      if (p < k) codes[p] = repro::quant_code(r.v[j], lo, step, n_bins);
      ++p;
    }
  }
  for (int j = min(count, k) + t.rank; j < k; j += t.size)
    codes[j] = repro::quant_code(0.f, lo, step, n_bins);
  if (t.rank == 0) {
    static_cast<float*>(a.out2)[row * 2] = lo;
    static_cast<float*>(a.out2)[row * 2 + 1] = step;
  }
}

template <int kMaxThreads, bool kSelect, int R>
__global__ void __launch_bounds__(kMaxThreads)
encode_rows_kernel(const EncodeArgs a) {
  extern __shared__ repro::TeamScratch scratch[];
  const int size = blockDim.x / a.teams;
  const int id = threadIdx.x / size;
  const repro::Team t{id, size, static_cast<int>(threadIdx.x) - id * size,
                      &scratch[id]};
  const long long r0 = static_cast<long long>(blockIdx.x) * a.group_rows;
  const long long r1 = min(r0 + a.group_rows,
                           static_cast<long long>(a.rows));
  for (long long row = r0 + id; row < r1; row += a.teams) {
    encode_row<kSelect, R>(a, row, t);
    if (row + a.teams < r1) t.sync();   // scratch free for the next row
  }
  if (a.idx_words == nullptr && a.code_words == nullptr) return;
  __syncthreads();              // the block's leaves are complete
  if (a.idx_words != nullptr)
    repro::pack_rows(static_cast<const int*>(a.out1), a.k, a.idx_bits,
                     a.idx_words, r0, r1, a.rows, threadIdx.x, blockDim.x);
  if (a.code_words != nullptr)
    repro::pack_rows(static_cast<const int*>(a.out0),
                     a.kind == repro::kQuant ? a.d : a.k, a.bits,
                     a.code_words, r0, r1, a.rows, threadIdx.x, blockDim.x);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The fewest rows (a power of two, at most 32) whose streams of
// `row_bits` bits each fill whole u32 words.
int group_rows(long long row_bits) {
  int g = 1;
  while (g < 32 && (row_bits * g) % 32 != 0) g <<= 1;
  return g;
}

// `core.wire.index_bits`: max(1, ceil(log2(d))).
int index_bits(int d) {
  int r = 1;
  while ((1 << r) < d) ++r;
  return r;
}

template <int kMaxThreads, bool kSelect, int R>
void set_smem_attr() {
  cudaFuncSetAttribute(encode_rows_kernel<kMaxThreads, kSelect, R>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       32 * static_cast<int>(sizeof(repro::TeamScratch)));
}

template <int kMaxThreads, int R>
void dispatch(const EncodeArgs& a, dim3 grid, int block, size_t smem,
              cudaStream_t s) {
  if (a.select)
    encode_rows_kernel<kMaxThreads, true, R><<<grid, block, smem, s>>>(a);
  else
    encode_rows_kernel<kMaxThreads, false, R><<<grid, block, smem, s>>>(a);
}

int launch(EncodeArgs a, void* stream) {
  const int d = a.d;
  const bool k_kind = a.kind != repro::kDense && a.kind != repro::kQuant;
  const bool q_kind = a.kind == repro::kQuant ||
                      a.kind == repro::kSparseQuant;
  if (d < 1 || d > repro::kMaxD || (k_kind && (a.k < 1 || a.k > d)) ||
      (q_kind && (a.bits < 1 || a.bits > 8)))
    return static_cast<int>(cudaErrorInvalidValue);
  a.idx_bits = index_bits(d);
  const int run = repro::run_len(d);
  a.vec = d % run == 0 && aligned16(a.x) && aligned16(a.out0) &&
          (a.mask == nullptr || aligned16(a.mask));
  int group = 1;
  if (a.idx_words != nullptr)
    group = max(group, group_rows(static_cast<long long>(a.k) * a.idx_bits));
  if (a.code_words != nullptr)
    group = max(group, group_rows(static_cast<long long>(
        a.kind == repro::kQuant ? d : a.k) * a.bits));
  // every row of a block in flight at once where 1024 threads hold them
  // (one warp a row up to d = 128); wider teams sync on named barriers,
  // so at most 8 of them
  const int threads = repro::row_threads(d, run);
  int teams = min(group, max(1, 1024 / threads));
  if (threads > 32) teams = min(teams, 8);
  a.group_rows = group;
  a.teams = teams;
  const long long blocks = (a.rows + group - 1) / group;
  const size_t smem = teams * sizeof(repro::TeamScratch);
  static bool attr_set = false;
  if (!attr_set) {
    set_smem_attr<1024, false, repro::kRunNarrow>();
    set_smem_attr<1024, true, repro::kRunNarrow>();
    set_smem_attr<1024, false, repro::kRunWide>();
    set_smem_attr<1024, true, repro::kRunWide>();
    attr_set = true;
  }
  const dim3 grid(static_cast<unsigned>(blocks));
  const int block = teams * threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool narrow = run == repro::kRunNarrow;
  if (block <= 512) {
    if (narrow)
      dispatch<512, repro::kRunNarrow>(a, grid, block, smem, s);
    else
      dispatch<512, repro::kRunWide>(a, grid, block, smem, s);
  } else if (narrow) {
    dispatch<1024, repro::kRunNarrow>(a, grid, block, smem, s);
  } else {
    dispatch<1024, repro::kRunWide>(a, grid, block, smem, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (rows, d) f32/bf16; mask: (rows, d) bytes, nonzero = selected (mask
// kinds only). Outputs per kind (row-major, leading dim rows):
//   dense (d) f32 | slice (k) f32 | sparse (k) f32, (k) i32 |
//   quant (d) i32, (2) f32 | sparse_quant (k) i32, (k) i32, (2) f32 |
//   mask (k) f32, (ceil(d/32)) u32.
// Requires 1 <= d <= 16384, 1 <= k <= d for the k kinds, 1 <= bits <= 8
// for the quant kinds.
extern "C" int encode_rows(const void* x, int is_bf16, const void* mask,
                           int rows, int d, int kind, int k, int bits,
                           void* out0, void* out1, void* out2,
                           void* stream) {
  EncodeArgs a{};
  a.x = x;
  a.mask = static_cast<const uint8_t*>(mask);
  a.is_bf16 = is_bf16;
  a.d = d;
  a.rows = rows;
  a.kind = kind;
  a.k = k;
  a.bits = bits;
  a.out0 = out0;
  a.out1 = out1;
  a.out2 = out2;
  return launch(a, stream);
}

// The serving client's codec in one launch: `encode_rows`' leaves with the
// support either given (`mask`) or the row's own top-k by |x| (`select`,
// mask null), plus the packed streams of the wire: `idx_words` gets the
// rows' indices at index_bits(d) bits each (sparse, sparse_quant),
// `code_words` their codes at `bits` each (quant: d a row, sparse_quant: k),
// ceil(rows * per_row / 32) * width words each, zero past the last value.
// Either may be null (not packed).
extern "C" int encode_sections(const void* x, int is_bf16, const void* mask,
                               int rows, int d, int kind, int k, int bits,
                               int select, void* out0, void* out1,
                               void* out2, void* idx_words,
                               void* code_words, void* stream) {
  EncodeArgs a{};
  a.x = x;
  a.mask = static_cast<const uint8_t*>(mask);
  a.is_bf16 = is_bf16;
  a.d = d;
  a.rows = rows;
  a.kind = kind;
  a.k = k;
  a.bits = bits;
  a.select = select;
  a.out0 = out0;
  a.out1 = out1;
  a.out2 = out2;
  a.idx_words = static_cast<unsigned*>(idx_words);
  a.code_words = static_cast<unsigned*>(code_words);
  return launch(a, stream);
}
