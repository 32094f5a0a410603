// Fused per-row uniform quantize / dequantize (Eq. 2 of the paper).
//
// Replaces the Pallas kernel `quantize`
// (src/repro/kernels/quant/kernel.py:34, body `_quant_kernel` :18), which
// computes a row tile's [min, max], the b-bit codes and the dequantized
// values in one VMEM pass.
//
// What bounds it on an H100: memory. Per element it reads 2 or 4 bytes and
// writes 1 + 2 or 1 + 4, against a handful of f32 operations, far below the
// card's ratio of operations to bytes. The design reads each row twice
// from global memory (the second read mostly from L2) and keeps nothing in
// shared memory but the reduction:
//   * one block per row (d <= 16384); each thread folds a strided slice of
//     the row into a min and a max, warp shuffles reduce them, one warp
//     reduces the per-warp results;
//   * one pass writes the codes (u8) and the dequantized values (f32, or
//     bf16 by __float2bfloat16_rn) and thread 0 writes lo and step.
// Codes must equal the plain version's bit for bit, so (x - lo) / step is
// spelled with __fsub_rn and __fdiv_rn (no contraction into an FMA can
// move a floor), and the dequantization rounds each operation on its own
// (__fmul_rn, __fadd_rn), as the plain version's separate tensor ops do.
// A constant row gives step 1.0 and no NaN; NaN input is out of scope.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const void* x, int is_bf16, int d, int bits, uint8_t* code,
                void* deq, float* lo_out, float* step_out) {
  __shared__ float warp_lo[kThreads / 32], warp_hi[kThreads / 32];
  __shared__ float row_lo, row_step;
  const long long off = static_cast<long long>(blockIdx.x) * d;
  const float kInf = __int_as_float(0x7f800000);
  float lo = kInf, hi = -kInf;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float v = repro::load_f(x, is_bf16, off + i);
    lo = fminf(lo, v);
    hi = fmaxf(hi, v);
  }
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(repro::kFull, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(repro::kFull, hi, o));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    warp_lo[warp] = lo;
    warp_hi[warp] = hi;
  }
  __syncthreads();
  if (warp == 0) {
    lo = lane < kThreads / 32 ? warp_lo[lane] : kInf;
    hi = lane < kThreads / 32 ? warp_hi[lane] : -kInf;
    for (int o = 16; o > 0; o >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(repro::kFull, lo, o));
      hi = fmaxf(hi, __shfl_xor_sync(repro::kFull, hi, o));
    }
    if (lane == 0) {
      const float n_bins = static_cast<float>(1 << bits);
      float step = __fdiv_rn(__fsub_rn(hi, lo), n_bins);
      if (!(step > 0.f)) step = 1.f;
      row_lo = lo;
      row_step = step;
      lo_out[blockIdx.x] = lo;
      step_out[blockIdx.x] = step;
    }
  }
  __syncthreads();
  lo = row_lo;
  const float step = row_step;
  const float top = static_cast<float>((1 << bits) - 1);
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float v = repro::load_f(x, is_bf16, off + i);
    const float c = fminf(fmaxf(floorf(__fdiv_rn(__fsub_rn(v, lo), step)),
                                0.f), top);
    code[off + i] = static_cast<uint8_t>(c);
    const float r = __fadd_rn(lo, __fmul_rn(__fadd_rn(c, 0.5f), step));
    if (is_bf16)
      static_cast<__nv_bfloat16*>(deq)[off + i] = __float2bfloat16_rn(r);
    else
      static_cast<float*>(deq)[off + i] = r;
  }
}

}  // namespace

// x: (rows, d) f32 or bf16; code: (rows, d) u8; deq: (rows, d) in x's
// dtype; lo, step: (rows,) f32. Requires 1 <= d, 1 <= bits <= 8. Returns
// cudaGetLastError() of the launch.
extern "C" int quantize(const void* x, int is_bf16, int rows, int d,
                        int bits, void* code, void* deq, void* lo,
                        void* step, void* stream) {
  quantize_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, is_bf16, d, bits, static_cast<uint8_t*>(code), deq,
      static_cast<float*>(lo), static_cast<float*>(step));
  return static_cast<int>(cudaGetLastError());
}
