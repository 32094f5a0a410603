// Decode payload rows of any kind to dense rows, with an optional fused
// (d, p) cut-projection; and the bare sparse scatter.
//
// Replaces two Pallas kernels:
//   * `decode_rows_kernel` (src/repro/kernels/decode/kernel.py:181, bodies
//     `_make_rows_kernel` :145 and `_decode_block` :124): wire leaves of
//     any of six kinds -> dense f32 rows, optionally times a (d, p) matrix,
//     stored in the requested dtype;
//   * `scatter_rows_kernel` (src/repro/kernels/randtopk/kernel.py:199, body
//     `_scatter_rows_kernel` :100): (values, indices) -> dense rows in the
//     values' dtype, duplicates summed in f32 — the sparse branch of the
//     decode without the projection, launched here as `scatter_rows`.
// The Pallas kernels place each of the k support values by a k-step
// compare-and-select over the whole row because the TPU has no scatter;
// here a block builds its row in shared memory with atomicAdd.
//
// What bounds it on an H100: at the training shapes (1024 rows of d = 4096,
// k = 64, bf16 out) a sparse decode reads 512 KB of leaves and writes 8 MB
// of rows, 2.6 us of HBM time: the store of the dense rows dominates, so
// the design writes each output element exactly once, coalesced:
//   * one block per row; the row is built in f32 in shared memory by
//     `repro::decode_row` (decode_row.cuh, shared with decode_to_slots.cu);
//   * barrier, then one convert-and-store pass into the output dtype.
// The bare scatter (`scatter_rows`) has its own kernel: a block takes
// several consecutive rows at once (32 KB of f32 rows in shared memory: 2
// rows at d = 4096, so 512 blocks of 256 threads for 1024 rows), zeroes
// them with 16-byte stores, barrier, adds the block's rows * k values at
// their indices with shared atomics, barrier, and stores the rows as one
// contiguous run of 16-byte vectors (8 bf16 or 4 f32); the whole block
// waits on two barriers, not two per row.
// With a projection, the decoded f32 rows go to a scratch buffer and a
// second kernel multiplies them by w: a plain shared-memory tiled f32
// product (64 x 64 output tile per block of 256 threads, 4 x 4 outputs per
// thread, 16-deep k tiles), bound by f32 operations (2 * rows * d * p
// against 67 TFLOP/s) at any real width. It is right, not fast: no tensor
// cores, since the reference's epilogue is an f32 product.
#include "decode_row.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxD = 16384;
constexpr int kBM = 64, kBN = 64, kBK = 16;   // projection tiles

__global__ void __launch_bounds__(kThreads)
decode_rows_kernel(int d, int kind, int k, const void* values, int vals_bf16,
                   const int* indices, const float* header, void* out,
                   int out_bf16) {
  extern __shared__ float rowbuf[];             // d
  __shared__ int warp_sums[33];
  const long long r = blockIdx.x;
  repro::decode_row(rowbuf, d, r, kind, k, values, vals_bf16, indices,
                    header, warp_sums);
  repro::store_row(rowbuf, d,
                   out_bf16 ? static_cast<void*>(
                                  static_cast<__nv_bfloat16*>(out) + r * d)
                            : static_cast<void*>(
                                  static_cast<float*>(out) + r * d),
                   out_bf16);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Rows [blockIdx.x * R, + R) of the sparse scatter, in T (float or bf16).
template <typename T>
__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(int rows, int d, int k, int R, const T* values,
                    const int* indices, T* out) {
  extern __shared__ float4 scatter_buf[];                 // R * d floats
  float* buf = reinterpret_cast<float*>(scatter_buf);
  const long long row0 = static_cast<long long>(blockIdx.x) * R;
  const int nr = static_cast<int>(min(static_cast<long long>(R),
                                      rows - row0));
  repro::zero_shared(buf, nr * d);
  __syncthreads();
  const int* idx = indices + row0 * k;
  const T* val = values + row0 * k;
  for (int j = threadIdx.x; j < nr * k; j += kThreads) {
    const int at = idx[j];
    if (at >= 0 && at < d) atomicAdd(&buf[(j / k) * d + at], to_f(val[j]));
  }
  __syncthreads();
  repro::store_flat(buf, nr * d, out + row0 * d);
}

constexpr int kScatterFloats = 8192;          // 32 KB of rows per block

template <typename T>
int launch_scatter(const void* values, const int* idx, int rows, int d,
                   int k, void* out, cudaStream_t s) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaFuncSetAttribute(scatter_rows_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kMaxD * static_cast<int>(sizeof(float)));
    attr_set = true;
  }
  const int R = max(1, min(8, kScatterFloats / d));
  scatter_rows_kernel<<<(rows + R - 1) / R, kThreads,
                        static_cast<size_t>(R) * d * sizeof(float), s>>>(
      rows, d, k, R, static_cast<const T*>(values), idx,
      static_cast<T*>(out));
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

void set_smem_attr() {
  static bool attr_set = false;
  if (!attr_set) {
    cudaFuncSetAttribute(decode_rows_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kMaxD * static_cast<int>(sizeof(float)));
    attr_set = true;
  }
}

}  // namespace

// Leaves of the kind, leading dim rows: values f32 or bf16 (`vals_bf16`;
// dense/slice/sparse/mask) or int32 codes (quant kinds), indices int32
// (sparse kinds) or u32 mask words, header (rows, 2) f32 (quant kinds).
// Without w (null): out (rows, d) in f32 or bf16 (`out_bf16`). With w
// (d, p) f32: the f32 rows go to `scratch` (rows, d) and out is (rows, p).
// Requires d <= 16384. Returns cudaGetLastError() after the launches.
extern "C" int decode_rows(const void* values, int vals_bf16,
                           const void* indices, const void* header, int rows,
                           int d, int kind, int k, const void* w, int p,
                           void* scratch, void* out, int out_bf16,
                           void* stream) {
  set_smem_attr();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool project = w != nullptr;
  decode_rows_kernel<<<rows, kThreads, d * sizeof(float), s>>>(
      d, kind, k, values, vals_bf16, static_cast<const int*>(indices),
      static_cast<const float*>(header), project ? scratch : out,
      project ? 0 : out_bf16);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !project) return static_cast<int>(err);
  const dim3 grid((p + kBN - 1) / kBN, (rows + kBM - 1) / kBM);
  project_rows_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(scratch), static_cast<const float*>(w), out,
      out_bf16, rows, d, p);
  return static_cast<int>(cudaGetLastError());
}

// values: (rows, k) f32 or bf16 (`vals_bf16`); indices: (rows, k) int32;
// out: (rows, d) in the values' dtype, zeros off the support, duplicate
// indices summed in f32, indices outside [0, d) dropped. Requires
// d <= 16384.
extern "C" int scatter_rows(const void* values, int vals_bf16,
                            const void* indices, int rows, int d, int k,
                            void* out, void* stream) {
  if (d < 1 || d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* idx = static_cast<const int*>(indices);
  return vals_bf16 ? launch_scatter<__nv_bfloat16>(values, idx, rows, d, k,
                                                   out, s)
                   : launch_scatter<float>(values, idx, rows, d, k, out, s);
}
