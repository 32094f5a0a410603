// Causal / sliding-window GQA attention forward with an online softmax.
//
// Replaces the Pallas kernel `flash_attention`
// (src/repro/kernels/flashattn/kernel.py:67, body `_flash_kernel` :27):
// per (batch, q head, q tile) it walks the KV tiles of the head's KV head
// h / (Hq / Hkv) with running (max, sum of exp, accumulator) in f32, so no
// (S, S) score tensor reaches device memory. It computes the Pallas
// kernel's function, not its blocking: q pre-scaled by hd^-1/2, masked
// scores -1e30 (the causal mask k <= q, the window k > q - window, the
// window also without causal), p = exp(s - m_new), l and acc rescaled by
// exp(m - m_new), out = acc / max(l, 1e-30) in q's dtype, all in f32.
//
// What bounds it on an H100: at yi-6b's shapes the work is 4 * hd
// operations per visible (q, k) pair against 2-4 bytes per element of
// q, k, v and out, so it is bound by operations: the bf16 tensor cores'
// 989 TFLOP/s would bound a tensor-core kernel. This first kernel is the
// simple, correct one: plain f32 FMAs from shared memory (no mma, no
// wgmma, no TMA), one CTA of 256 threads per (q tile, q head, batch):
//   * the q tile (pre-scaled), the K and V tiles, the score tile and the
//     output accumulator live in shared memory as f32 (about 145 KB at
//     bq = bk = 64, hd = 128, above the 48 KB default, so the launcher
//     raises the dynamic shared-memory limit); K rows are padded by one
//     float so the score loop reads them without bank conflicts;
//   * KV tiles that the mask hides from every row of the q tile are
//     skipped: behind the causal diagonal their scores give p = 0, and
//     before the window they precede every visible key, so the first
//     visible tile's rescale by exp(-1e30 - m) = 0 clears them: skipping
//     changes no bit of the result;
//   * one warp per row finds the tile's row max and sum with shuffles.
// Head dims 32, 64 and 128 are compiled.
#include "common.cuh"

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
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               int is_bf16, int B, int S, int Hq, int Hkv,
                               int hd, int bq, int bk, int causal,
                               int window, float scale, void* out,
                               void* stream) {
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
