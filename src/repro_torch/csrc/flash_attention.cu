// Causal / sliding-window GQA attention forward with an online softmax:
// a tensor-core kernel for bf16 and a SIMT kernel for f32.
//
// Replaces the Pallas kernel `flash_attention`
// (src/repro/kernels/flashattn/kernel.py:67, body `_flash_kernel` :27):
// per (batch, q head, q tile) it walks the KV tiles of the head's KV head
// h / (Hq / Hkv) with running (max, sum of exp, accumulator) in f32, so no
// (S, S) score tensor reaches device memory. It computes the Pallas
// kernel's function, not its blocking: q scaled by hd^-1/2, masked scores
// -1e30 (the causal mask k <= q, the window k > q - window, the window
// also without causal), p = exp(s - m_new), l and acc rescaled by
// exp(m - m_new), out = acc / max(l, 1e-30) in q's dtype, all in f32.
//
// Both kernels skip the KV tiles that the mask hides from every row of
// their q tile: behind the causal diagonal their scores give p = 0, and
// before the window they precede every visible key, so the first visible
// tile's rescale by exp(-1e30 - m) = 0 clears them: skipping changes no
// bit of the result.
//
// What bounds it on an H100: 4 hd operations per visible (q, k) pair
// against 2 bytes per element of q, k, v and out. At yi-6b's training
// shape (B 4, S 256, Hq 32, Hkv 4, hd 128, causal) that is 2.15 GFLOP for
// 18.9 MB, so bytes bound it (5.6 us at 3.35 TB/s, 2.2 us of bf16 tensor
// time); at S 4096 it is 137 GFLOP against the bf16 tensor cores' 989
// TFLOP/s (0.139 ms), so operations bound it. The bf16 kernel answers
// both: no score leaves the chip, q is read once and each K and V tile
// once per CTA (the CTAs of the q heads that share it read it from L2),
// and both products run on the tensor cores with the softmax overlapping
// P.V.
//
// bf16, `flash_attention` (the tensor-core kernel, `flash_tc_kernel`):
//   * a CTA owns 128 q rows of one q head, one warpgroup per 64 rows, and
//     the grid orders the CTAs so that the Hq / Hkv q heads sharing a KV
//     head run next to each other (their K and V tiles hit L2), the
//     longest (last, under the causal mask) q tiles first;
//   * the Q tile is copied once by cp.async into shared memory and from
//     there into registers, as the A fragments of Q.K^T; K and V tiles of
//     64 keys stream through three stages by cp.async, in bf16, in the
//     128-byte swizzle that wgmma reads (wgmma.cuh);
//   * S = Q.K^T and O += P.V run on the tensor cores as wgmma.mma_async
//     m64n64k16 bf16 -> f32 with A from registers: Q, and P straight from
//     the S accumulator (its layout is the A fragment's), K through a
//     K-major descriptor and V through the transposed-B one;
//   * software pipelining: iteration j issues S_j = Q.K_j^T and
//     O += P_{j-1}.V_{j-1}, copies tile j + 1, and runs tile j's softmax
//     while P.V is still in flight, so tiles j - 1, j and j + 1 are live;
//   * the scores, running max and sum and the O accumulator stay in
//     registers; a row's max reduces as a tree over the thread's values,
//     then over the four lanes that share the row by shuffles, its sum in
//     two partial sums; p = exp2(s c - m c) with c = log2(e) hd^-1/2 is
//     one FMA and one ex2 (the reference's exp(s hd^-1/2 - m)); P is
//     rounded to bf16 only as the operand of P.V, where the plain version
//     rounds its weights;
//   * masks are evaluated only on tiles that cross the diagonal, the
//     window's edge or the end of the sequence, with -2^100 as the masked
//     raw score (see kMaskedRaw) and -inf for keys past S (their
//     zero-filled K and V rows add nothing); q rows past S are not
//     stored, so S need not be a multiple of the tile;
//   * the epilogue divides by max(l, 1e-30), rounds to bf16, stages the
//     tile in the warpgroup's own Q rows and stores 16-byte vectors.
//   Head dims 32, 64 and 128; 32 is zero-padded to 64 in shared memory.
//   No producer warp, no TMA, one CTA per SM (ROADMAP Queue 4 has them).
//
// f32, `flash_attention_simt` (`flash_fwd_kernel`): the first kernel,
// plain f32 FMAs from shared memory (no tensor cores: TF32 would not meet
// the f32 checks' 3e-5), one CTA of 256 threads per (q tile, q head,
// batch): the q tile (pre-scaled), the K and V tiles, the score tile and
// the output accumulator in shared memory as f32 (about 145 KB at bq = bk
// = 64, hd = 128, so the launcher raises the dynamic shared-memory limit);
// K rows padded by one float so the score loop reads them without bank
// conflicts; one warp per row finds the tile's row max and sum with
// shuffles. Head dims 32, 64 and 128.
#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;        // 227 KB, the H100's per-block cap
constexpr float kMasked = -1e30f;

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const void* q, const void* k, const void* v, int is_bf16,
                 int S, int Hq, int Hkv, int bq, int bk, int causal,
                 int window, float scale, void* out) {
  extern __shared__ float sm[];
  float* Qs = sm;                       // bq x HD
  float* Ks = Qs + bq * HD;             // bk x (HD + 1)
  float* Vs = Ks + bk * (HD + 1);       // bk x HD
  float* Ps = Vs + bk * HD;             // bq x (bk + 1)
  float* Os = Ps + bq * (bk + 1);       // bq x HD
  float* ms = Os + bq * HD;             // bq running max
  float* ls = ms + bq;                  // bq running sum of exp
  float* cs = ls + bq;                  // bq rescale of this tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = kThreads / 32;
  const int q0 = blockIdx.x * bq, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int pb = bk + 1;

  for (int e = tid; e < bq * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    const long long gi = ((static_cast<long long>(b) * S + q0 + r) * Hq + h)
                         * HD + d;
    Qs[e] = __fmul_rn(repro::load_f(q, is_bf16, gi), scale);
    Os[e] = 0.f;
  }
  for (int r = tid; r < bq; r += kThreads) {
    ms[r] = kMasked;
    ls[r] = 0.f;
  }
  int j_lo = 0, j_hi = S / bk;
  if (causal) j_hi = min(j_hi, (q0 + bq - 1) / bk + 1);
  if (window && q0 - window + 1 > 0) j_lo = (q0 - window + 1) / bk;

  for (int j = j_lo; j < j_hi; ++j) {
    const int k0 = j * bk;
    __syncthreads();                    // the last tile's readers are done
    for (int e = tid; e < bk * HD; e += kThreads) {
      const int c = e / HD, d = e % HD;
      const long long gi = ((static_cast<long long>(b) * S + k0 + c) * Hkv
                            + hk) * HD + d;
      Ks[c * (HD + 1) + d] = repro::load_f(k, is_bf16, gi);
      Vs[e] = repro::load_f(v, is_bf16, gi);
    }
    __syncthreads();
    for (int e = tid; e < bq * bk; e += kThreads) {
      const int r = e / bk, c = e % bk;
      const float* qr = Qs + r * HD;
      const float* kc = Ks + c * (HD + 1);
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) s = fmaf(qr[d], kc[d], s);
      const int qp = q0 + r, kp = k0 + c;
      bool ok = true;
      if (causal) ok = ok && kp <= qp;
      if (window) ok = ok && kp > qp - window;
      Ps[r * pb + c] = ok ? s : kMasked;
    }
    __syncthreads();
    for (int r = warp; r < bq; r += n_warps) {
      float* pr = Ps + r * pb;
      float mx = kMasked;
      for (int c = lane; c < bk; c += 32) mx = fmaxf(mx, pr[c]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(repro::kFull, mx, o));
      const float m_old = ms[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = lane; c < bk; c += 32) {
        const float p = expf(pr[c] - m_new);
        pr[c] = p;
        sum += p;
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(repro::kFull, sum, o);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        ls[r] = ls[r] * corr + sum;
        ms[r] = m_new;
        cs[r] = corr;
      }
    }
    __syncthreads();
    for (int e = tid; e < bq * HD; e += kThreads) {
      const int r = e / HD, d = e % HD;
      const float* pr = Ps + r * pb;
      float acc = 0.f;
#pragma unroll 8
      for (int c = 0; c < bk; ++c) acc = fmaf(pr[c], Vs[c * HD + d], acc);
      Os[e] = Os[e] * cs[r] + acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < bq * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    const float o = Os[e] / fmaxf(ls[r], 1e-30f);
    const long long gi = ((static_cast<long long>(b) * S + q0 + r) * Hq + h)
                         * HD + d;
    if (is_bf16)
      static_cast<__nv_bfloat16*>(out)[gi] = __float2bfloat16_rn(o);
    else
      static_cast<float*>(out)[gi] = o;
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, int is_bf16, int B,
           int S, int Hq, int Hkv, int bq, int bk, int causal, int window,
           float scale, void* out, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaFuncSetAttribute(flash_fwd_kernel<HD>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kMaxSmem);
    attr_set = true;
  }
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(bq) * HD * 2 + static_cast<size_t>(bk) *
       (2 * HD + 1) + static_cast<size_t>(bq) * (bk + 1) + 3 * bq);
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(S / bq, Hq, B);
  flash_fwd_kernel<HD><<<grid, kThreads, smem, stream>>>(
      q, k, v, is_bf16, S, Hq, Hkv, bq, bk, causal, window, scale, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, S, Hq, hd), k and v: (B, S, Hkv, hd), all f32 or all bf16; out:
// (B, S, Hq, hd) in their dtype. Requires hd in {32, 64, 128}, Hq % Hkv
// == 0, S % bq == 0 and S % bk == 0, and the shared memory of the tiles
// within 227 KB (the wrapper checks). Returns cudaGetLastError() of the
// launch, or cudaErrorInvalidValue for an unsupported hd or tiling.
extern "C" int flash_attention_simt(const void* q, const void* k,
                                    const void* v, int is_bf16, int B,
                                    int S, int Hq, int Hkv, int hd, int bq,
                                    int bk, int causal, int window,
                                    float scale, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch<32>(q, k, v, is_bf16, B, S, Hq, Hkv, bq, bk, causal,
                        window, scale, out, st);
    case 64:
      return launch<64>(q, k, v, is_bf16, B, S, Hq, Hkv, bq, bk, causal,
                        window, scale, out, st);
    case 128:
      return launch<128>(q, k, v, is_bf16, B, S, Hq, Hkv, bq, bk, causal,
                         window, scale, out, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

namespace {

namespace wg = repro::wg;

constexpr int kTcRows = 128;            // q rows per CTA: two warpgroups
constexpr int kTcKeys = 64;             // keys per KV tile
constexpr int kTcThreads = 256;
constexpr int kStages = 3;              // K and V tiles in flight
// A masked raw score: a power of two, so that its product with the scale
// is exact and exp2(s c - m c) is exactly 1 where a row has seen nothing
// but masked keys (the reference's exp(-1e30 - -1e30)), and exactly 0
// against any visible score.
constexpr float kMaskedRaw = -1.2676506002282294e30f;   // -2^100

// Shared memory of the tensor-core kernel at head dim hd (padded to 64):
// the Q tile, kStages stages of K and V tiles, and 1 KB to align them.
constexpr int tc_smem_bytes(int hdp) {
  return 1024 + kTcRows * hdp * 2 + kStages * 2 * kTcKeys * hdp * 2;
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, int S, int Hq, int Hkv,
                int causal, int window, float scale_log2,
                __nv_bfloat16* __restrict__ out) {
  constexpr int HDP = HD < 64 ? 64 : HD;  // columns held in shared memory
  constexpr int NC = HDP / 64;            // 64-column chunks
  constexpr int CH = HD / 8;              // 16-byte units of a real row
  constexpr uint32_t kTile = kTcKeys * HDP * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = wg::smem_addr(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  uint8_t* sm = smem_raw + pad;           // generic pointer of sQ
  const uint32_t sQ = raw + pad;          // kTcRows x HDP
  const uint32_t sK = sQ + kTcRows * HDP * 2;   // stages of kTcKeys x HDP
  const uint32_t sV = sK + kStages * kTile;

  // CTA -> (batch, kv head, q tile, q head of the group), the group's q
  // heads adjacent, the q tiles from the last
  const int g = Hq / Hkv;
  const int nq = (S + kTcRows - 1) / kTcRows;
  int id = blockIdx.x;
  const int hg = id % g;
  id /= g;
  const int q0 = (nq - 1 - id % nq) * kTcRows;
  id /= nq;
  const int hk = id % Hkv;
  const int b = id / Hkv;
  const int h = hk * g + hg;

  const int tid = threadIdx.x;
  const int wgi = tid >> 7;               // warpgroup: q rows 64 wgi ...
  const int wtid = tid & 127;
  const int lane = tid & 31;
  const int qw = q0 + 64 * wgi;           // the warpgroup's first q row
  const bool active = qw < S;

  // KV tiles: [lo, hi) of the CTA and of this warpgroup
  const int nk = (S + kTcKeys - 1) / kTcKeys;
  auto first_tile = [&](int r) {
    return window && r - window + 1 > 0 ? (r - window + 1) / kTcKeys : 0;
  };
  auto end_tile = [&](int r_last) {
    return causal ? min(nk, min(r_last, S - 1) / kTcKeys + 1) : nk;
  };
  const int j_lo = first_tile(q0);
  const int j_hi = end_tile(q0 + kTcRows - 1);
  const int w_lo = first_tile(qw);
  const int w_hi = end_tile(qw + 63);

  if constexpr (HD < HDP) {               // zero the padding columns
    uint4* z = reinterpret_cast<uint4*>(sm);
    for (int i = tid; i < (kTcRows * HDP * 2 + 2 * kStages * kTile) / 16;
         i += kTcThreads)
      z[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }

  const long long q_row = static_cast<long long>(Hq) * HD;
  const long long kv_row = static_cast<long long>(Hkv) * HD;
  const __nv_bfloat16* qb = q + static_cast<long long>(b) * S * q_row +
                            h * HD;
  const __nv_bfloat16* kb = k + static_cast<long long>(b) * S * kv_row +
                            hk * HD;
  const __nv_bfloat16* vb = v + static_cast<long long>(b) * S * kv_row +
                            hk * HD;
  for (int e = tid; e < kTcRows * CH; e += kTcThreads) {
    const int r = e / CH, c = (e % CH) * 8;
    const bool ok = q0 + r < S;
    wg::cp16(sQ + wg::swizzle_offset(kTcRows, r, c),
             qb + (ok ? q0 + r : 0) * q_row + c, ok);
  }
  // a thread copies the same 16-byte column unit of every (256 / CH)-th
  // row of a K or V tile, so its source and swizzled destination advance
  // by constants
  constexpr int kRowStep = kTcThreads / CH;
  const int lr0 = tid / CH, lc = (tid % CH) * 8;
  const uint32_t ldst = wg::swizzle_offset(kTcKeys, lr0, lc);
  auto load_kv = [&](int j, int stage) {
    const int r0 = j * kTcKeys + lr0;
#pragma unroll
    for (int i = 0; i < kTcKeys / kRowStep; ++i) {
      const int r = r0 + i * kRowStep;
      const bool ok = r < S;
      const long long at = (ok ? r : 0) * kv_row + lc;
      const uint32_t off = stage * kTile + ldst + i * kRowStep * 128;
      wg::cp16(sK + off, kb + at, ok);
      wg::cp16(sV + off, vb + at, ok);
    }
  };
  load_kv(j_lo, 0);                       // j_lo < j_hi: S >= 1
  wg::cp_commit();

  float o[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m0 = kMaskedRaw, m1 = kMaskedRaw, l0 = 0.f, l1 = 0.f;
  const int row0 = qw + 16 * ((tid >> 5) & 3) + (lane >> 2);  // and +8
  const int col_in = 2 * (lane & 3);

  // Every wgmma is issued by both warpgroups on every tile of the CTA's
  // range (a wgmma on a path the compiler cannot prove uniform is
  // serialized): a tile outside a warpgroup's own range, or a warpgroup
  // past S, gets P = 0 and a rescale of 1, which changes no bit of O.
  float s[32];
  uint32_t q_frag[HDP / 16][4];           // this warpgroup's Q, bf16
  auto issue_qk = [&](int j) {            // S = Q . K_j^T, HD / 16 slices
    const uint32_t kst = sK + ((j - j_lo) % kStages) * kTile;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wg::mma_rs<0>(s, q_frag[kk],
                    wg::desc(kst + (kk >> 2) * kTcKeys * 128 +
                             (kk & 3) * 32, 16, 1024));
    wg::commit();
  };
  uint32_t p_frag[kTcKeys / 16][4];       // P of the tile before, bf16
  auto issue_pv = [&](int j) {            // O += P . V_j
    const uint32_t vst = sV + ((j - j_lo) % kStages) * kTile;
#pragma unroll
    for (int c = 0; c < NC; ++c) wg::pin(o[c]);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kTcKeys / 16; ++kk)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        wg::mma_rs<1>(o[c], p_frag[kk],
                      wg::desc(vst + c * kTcKeys * 128 + kk * 16 * 128,
                               kTcKeys * 128, 1024));
    wg::commit();
  };
  // online softmax of tile j in registers: s becomes P (f32), l and m
  // advance, and (corr0, corr1) is O's rescale. The running max m stays in
  // the raw score's units; exp2(s * c - m * c) with c = log2(e) hd^-1/2 is
  // the reference's exp(s hd^-1/2 - max) as one FMA and one ex2.
  float corr0 = 1.f, corr1 = 1.f;
  auto softmax = [&](int j) {
    if (!(active && j >= w_lo && j < w_hi)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      corr0 = corr1 = 1.f;
      return;
    }
    const int k0 = j * kTcKeys;
    if ((causal && k0 + kTcKeys - 1 > qw) ||
        (window && k0 <= qw + 63 - window) || k0 + kTcKeys > S) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kp = k0 + 8 * (i >> 2) + col_in + (i & 1);
        const int qp = (i & 2) ? row0 + 8 : row0;
        if (kp >= S)
          s[i] = -INFINITY;
        else if ((causal && kp > qp) || (window && kp <= qp - window))
          s[i] = kMaskedRaw;
      }
    }
    // row maxima as trees over the thread's 16 values, then over the
    // four lanes that share the row
    float a0[8], a1[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      a0[b] = fmaxf(s[4 * b], s[4 * b + 1]);
      a1[b] = fmaxf(s[4 * b + 2], s[4 * b + 3]);
    }
#pragma unroll
    for (int w = 4; w > 0; w >>= 1)
#pragma unroll
      for (int b = 0; b < w; ++b) {
        a0[b] = fmaxf(a0[b], a0[b + w]);
        a1[b] = fmaxf(a1[b], a1[b + w]);
      }
    float mx0 = a0[0], mx1 = a1[0];
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(repro::kFull, mx0, o2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(repro::kFull, mx1, o2));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    corr0 = exp2f((m0 - mn0) * scale_log2);
    corr1 = exp2f((m1 - mn1) * scale_log2);
    m0 = mn0;
    m1 = mn1;
    const float mc0 = mn0 * scale_log2, mc1 = mn1 * scale_log2;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      s[i] = exp2f(fmaf(s[i], scale_log2, (i & 2) ? -mc1 : -mc0));
    // row sums in two partial sums per row
    float e0 = 0.f, f0 = 0.f, e1 = 0.f, f1 = 0.f;
#pragma unroll
    for (int b = 0; b < 8; b += 2) {
      e0 += s[4 * b] + s[4 * b + 1];
      f0 += s[4 * b + 4] + s[4 * b + 5];
      e1 += s[4 * b + 2] + s[4 * b + 3];
      f1 += s[4 * b + 6] + s[4 * b + 7];
    }
    l0 = l0 * corr0 + (e0 + f0);
    l1 = l1 * corr1 + (e1 + f1);
  };
  // P as bf16 A fragments straight from the S registers (slice kk: keys
  // 16 kk .. 16 kk + 15, n8 blocks 2 kk and 2 kk + 1), and O's rescale
  auto take_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kTcKeys / 16; ++kk)
#pragma unroll
      for (int w = 0; w < 4; ++w)
        p_frag[kk][w] = wg::pack_bf16(s[8 * kk + 2 * w],
                                      s[8 * kk + 2 * w + 1]);
    if (corr0 != 1.f || corr1 != 1.f) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[c][i] *= (i & 2) ? corr1 : corr0;
    }
  };

  // tile j_lo: S and its softmax; Q goes to registers once, as the A
  // fragments of its 16-column slices (rows +8 in words 1 and 3, columns
  // +8 in words 2 and 3)
  wg::cp_wait_all();
  wg::fence_async_shared();
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk)
#pragma unroll
    for (int w = 0; w < 4; ++w)
      q_frag[kk][w] = *reinterpret_cast<const uint32_t*>(
          sm + wg::swizzle_offset(kTcRows, row0 - q0 + (w & 1) * 8,
                                  16 * kk + col_in + (w >> 1) * 8));
  if (j_lo + 1 < j_hi) load_kv(j_lo + 1, 1);
  wg::cp_commit();
  issue_qk(j_lo);
  wg::wait<0>();
  wg::pin(s);
  softmax(j_lo);
  take_p();
  // tile j: S = Q.K_j^T and O += P_{j-1}.V_{j-1} on the tensor cores, then
  // tile j's softmax while P.V is still in flight; tile j + 1 is copied
  // meanwhile. Tiles j - 1, j and j + 1 are live at once: three stages.
  for (int j = j_lo + 1; j < j_hi; ++j) {
    wg::cp_wait_all();
    wg::fence_async_shared();
    __syncthreads();                      // tile j landed; j - 2 is free
    issue_qk(j);
    issue_pv(j - 1);
    if (j + 1 < j_hi) load_kv(j + 1, (j + 1 - j_lo) % kStages);
    wg::cp_commit();
    wg::wait<1>();                        // S is done, P.V may run on
    wg::pin(s);
    softmax(j);
    wg::wait<0>();
#pragma unroll
    for (int c = 0; c < NC; ++c) wg::pin(o[c]);
    take_p();
  }
  issue_pv(j_hi - 1);
  wg::wait<0>();
#pragma unroll
  for (int c = 0; c < NC; ++c) wg::pin(o[c]);
  if (!active) return;

  // out = O / max(l, 1e-30) in bf16, staged in this warpgroup's Q rows,
  // stored as 16-byte vectors
#pragma unroll
  for (int o2 = 1; o2 <= 2; o2 <<= 1) {
    l0 += __shfl_xor_sync(repro::kFull, l0, o2);
    l1 += __shfl_xor_sync(repro::kFull, l1, o2);
  }
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  const int r_in = 64 * wgi + (row0 - qw);
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i & 2) ? r_in + 8 : r_in;
      const int col = 64 * c + 8 * (i >> 2) + col_in;
      if (col < HD) {
        const float den = (i & 2) ? den1 : den0;
        *reinterpret_cast<uint32_t*>(
            sm + wg::swizzle_offset(kTcRows, r, col)) =
            wg::pack_bf16(o[c][i] / den, o[c][i + 1] / den);
      }
    }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wgi) : "memory");
  __nv_bfloat16* ob = out + static_cast<long long>(b) * S * q_row + h * HD;
  for (int e = wtid; e < 64 * CH; e += 128) {
    const int r = e / CH, c = (e % CH) * 8;
    if (qw + r < S)
      *reinterpret_cast<uint4*>(ob + (qw + r) * q_row + c) =
          *reinterpret_cast<const uint4*>(
              sm + wg::swizzle_offset(kTcRows, 64 * wgi + r, c));
  }
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, int B, int S,
              int Hq, int Hkv, int causal, int window, float scale_log2,
              void* out, cudaStream_t stream) {
  constexpr int smem = tc_smem_bytes(HD < 64 ? 64 : HD);
  static bool attr_set = false;
  if (!attr_set) {
    cudaFuncSetAttribute(flash_tc_kernel<HD>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    attr_set = true;
  }
  const long long ctas = static_cast<long long>(B) * Hq *
                         ((S + kTcRows - 1) / kTcRows);
  flash_tc_kernel<HD><<<static_cast<unsigned>(ctas), kTcThreads, smem,
                        stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), S, Hq, Hkv, causal, window,
      scale_log2, static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 only. q: (B, S, Hq, hd), k and v: (B, S, Hkv, hd), contiguous and
// 16-byte aligned; out: (B, S, Hq, hd) bf16. `scale_log2` is
// log2(e) * hd^-1/2. Requires hd in {32, 64, 128}, Hq % Hkv == 0 and
// S >= 1 (any S: the ragged tile is masked). Returns cudaGetLastError()
// of the launch, or cudaErrorInvalidValue for what it does not take.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               int B, int S, int Hq, int Hkv, int hd,
                               int causal, int window, float scale_log2,
                               void* out, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || Hq % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch_tc<32>(q, k, v, B, S, Hq, Hkv, causal, window,
                           scale_log2, out, st);
    case 64:
      return launch_tc<64>(q, k, v, B, S, Hq, Hkv, causal, window,
                           scale_log2, out, st);
    case 128:
      return launch_tc<128>(q, k, v, B, S, Hq, Hkv, causal, window,
                            scale_log2, out, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
