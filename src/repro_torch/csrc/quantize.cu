// Fused per-row uniform quantize / dequantize (Eq. 2 of the paper).
//
// Replaces the Pallas kernel `quantize`
// (src/repro/kernels/quant/kernel.py:34, body `_quant_kernel` :18), which
// computes a row tile's [min, max], the b-bit codes and the dequantized
// values in one VMEM pass.
//
// What bounds it on an H100: memory. Per element it reads 2 or 4 bytes and
// writes 1 + 2 or 1 + 4, against a handful of f32 operations, far below the
// card's ratio of operations to bytes: at 1024 x 4096 bf16, 8 MB in and
// 12 MB out, 6.26 us at 3.35 TB/s. The design reads x once and writes
// each output once, in 16-byte vectors where the row allows, with the row
// held in registers in between (the row-team machinery of common.cuh that
// the selection kernels and the fused encode share):
//   * one block per row, d <= 16384; each thread holds a run of
//     `run_len(d)` consecutive elements (4 up to d = 512, else 16), loaded
//     as whole vectors when d is a multiple of the run and x, the codes
//     and the values start 16-byte aligned (`load_run`), element by
//     element otherwise;
//   * the row's min and max reduce total-order keys (`order_key`,
//     `team_minmax`), so -0.0 sorts below +0.0 as XLA's min orders it: a
//     row whose least value is a zero and that holds a -0.0 reports
//     lo = -0.0, which `fminf` would not promise;
//   * codes by `quant_code` ((x - lo) / step with IEEE subtract and
//     divide, floor, clip: no contraction can move a floor) and values by
//     `dequant` (each operation rounded on its own), as the plain
//     version's separate tensor ops round, so codes, lo and step equal it
//     bit for bit; a thread stores its run's codes as one 16-byte (or
//     4-byte) vector of u8 and its values as 16-byte vectors (8 bytes of
//     bf16 at runs of 4); thread 0 stores lo and step.
// A constant row gives step 1.0 and no NaN; NaN input is out of scope.
#include "common.cuh"

namespace {

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// A run of R codes (each in [0, 255]) as R bytes: one 16-byte store per 16,
// one 4-byte store at R = 4.
template <int R>
__device__ __forceinline__ void store_codes(uint8_t* o, const int* c) {
  static_assert(R == 4 || R % 16 == 0, "a run is 4 or a multiple of 16");
  unsigned w[R / 4];
#pragma unroll
  for (int q = 0; q < R / 4; ++q) {
    w[q] = 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      w[q] |= static_cast<unsigned>(c[4 * q + b]) << (8 * b);
  }
  if constexpr (R == 4) {
    *reinterpret_cast<unsigned*>(o) = w[0];
  } else {
#pragma unroll
    for (int q = 0; q < R / 16; ++q)
      reinterpret_cast<uint4*>(o)[q] =
          make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
  }
}

// A run of R values: R / 4 16-byte f32 vectors, or R / 8 16-byte bf16
// vectors (one 8-byte store at R = 4).
template <int R>
__device__ __forceinline__ void store_values(float* o, const float* f) {
#pragma unroll
  for (int q = 0; q < R / 4; ++q)
    reinterpret_cast<float4*>(o)[q] =
        make_float4(f[4 * q], f[4 * q + 1], f[4 * q + 2], f[4 * q + 3]);
}

template <int R>
__device__ __forceinline__ void store_values(__nv_bfloat16* o,
                                             const float* f) {
  if constexpr (R == 4) {
    *reinterpret_cast<uint2*>(o) = make_uint2(
        repro::pack_bf16x2(f[0], f[1]), repro::pack_bf16x2(f[2], f[3]));
  } else {
#pragma unroll
    for (int q = 0; q < R / 8; ++q)
      reinterpret_cast<uint4*>(o)[q] = repro::pack_bf16x8(f + 8 * q);
  }
}

template <int R, typename T>
__device__ __forceinline__ void store_run(const float* v, int c0, int d,
                                          bool vec, float lo, float step,
                                          float n_bins, uint8_t* code,
                                          T* deq) {
  int c[R];
  float q[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    c[j] = repro::quant_code(v[j], lo, step, n_bins);
    q[j] = repro::dequant(c[j], lo, step);
  }
  if (vec) {
    store_codes<R>(code + c0, c);
    store_values<R>(deq + c0, q);
    return;
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    if (c0 + j < d) {
      code[c0 + j] = static_cast<uint8_t>(c[j]);
      repro::store_one(deq + c0 + j, q[j]);
    }
  }
}

template <int kMaxThreads, int R>
__global__ void __launch_bounds__(kMaxThreads)
quantize_kernel(const void* x, int is_bf16, int d, int bits, int vec,
                uint8_t* code, void* deq, float* lo_out, float* step_out) {
  __shared__ repro::TeamScratch scratch;
  const repro::Team t{0, static_cast<int>(blockDim.x),
                      static_cast<int>(threadIdx.x), &scratch};
  const long long off = static_cast<long long>(blockIdx.x) * d;
  const int c0 = t.rank * R;
  const unsigned valid = repro::run_valid<R>(c0, d);
  repro::Run<R> r;
  repro::load_run<R>(x, is_bf16, nullptr, off, c0, d, vec != 0, r);
  unsigned mn = ~0u, mx = 0u;
  repro::run_minmax<R>(r.v, valid, mn, mx);
  float lo, hi;
  repro::team_minmax(mn, mx, t, &lo, &hi);
  const float n_bins = static_cast<float>(1 << bits);
  float step = __fdiv_rn(__fsub_rn(hi, lo), n_bins);
  if (!(step > 0.f)) step = 1.f;
  if (t.rank == 0) {
    lo_out[blockIdx.x] = lo;
    step_out[blockIdx.x] = step;
  }
  if (c0 >= d) return;
  if (is_bf16)
    store_run<R>(r.v, c0, d, vec != 0, lo, step, n_bins, code + off,
                 static_cast<__nv_bfloat16*>(deq) + off);
  else
    store_run<R>(r.v, c0, d, vec != 0, lo, step, n_bins, code + off,
                 static_cast<float*>(deq) + off);
}

}  // namespace

// x: (rows, d) f32 or bf16; code: (rows, d) u8; deq: (rows, d) in x's
// dtype; lo, step: (rows,) f32. Requires 1 <= d <= 16384, 1 <= bits <= 8.
// Returns cudaGetLastError() of the launch.
extern "C" int quantize(const void* x, int is_bf16, int rows, int d,
                        int bits, void* code, void* deq, void* lo,
                        void* step, void* stream) {
  if (d < 1 || d > repro::kMaxD || bits < 1 || bits > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int run = repro::run_len(d);
  const int vec = d % run == 0 && aligned16(x) && aligned16(code) &&
                  aligned16(deq);
  const int threads = repro::row_threads(d, run);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* c = static_cast<uint8_t*>(code);
  float* l = static_cast<float*>(lo);
  float* st = static_cast<float*>(step);
  if (run == repro::kRunNarrow)
    quantize_kernel<512, repro::kRunNarrow><<<rows, threads, 0, s>>>(
        x, is_bf16, d, bits, vec, c, deq, l, st);
  else if (threads <= 512)   // up to 128 registers: a run, its codes
    quantize_kernel<512, repro::kRunWide><<<rows, threads, 0, s>>>(
        x, is_bf16, d, bits, vec, c, deq, l, st);
  else
    quantize_kernel<1024, repro::kRunWide><<<rows, threads, 0, s>>>(
        x, is_bf16, d, bits, vec, c, deq, l, st);
  return static_cast<int>(cudaGetLastError());
}
