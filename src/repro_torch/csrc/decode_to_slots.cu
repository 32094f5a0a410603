// Decode flush rows of any payload kind straight into the serving arena's
// cut-activation buffer: xbuf[slots[i]] = dense(row i), in place.
//
// Replaces the Pallas kernel `decode_to_slots_kernel`
// (src/repro/kernels/decode/kernel.py:224, bodies `_decode_block` :124,
// `_scatter_block` :61, `_dequant_block` :54, `_mask_expand_block` :108),
// which scalar-prefetches the slot ids into the output index map and
// scatters by a k-step compare-and-select loop over the row.
//
// What bounds it on an H100: a flush of n rows at d = 4096 reads n * 512
// bytes of sparse leaves and writes n * 8 KB of bf16 rows — a few ns of HBM
// time for the flushes the serving loop runs — so launch latency sets the
// pace. The design is one block per flush row, one pass:
//   * the block reads its own slots[i] (in place of the scalar prefetch);
//   * the dense f32 row is built in shared memory: zero it, barrier, then
//     the sparse scatter (shared atomicAdd, so duplicate indices sum as in
//     the Pallas accumulate; indices outside [0, d) are dropped, as no
//     Pallas lane matches them), the dequant lo + (code + 0.5) * step, the
//     mask expand (block prefix count of the set bits = value position),
//     or the dense/slice copy;
//   * barrier, then a coalesced convert-and-store of the row into
//     xbuf[slots[i]] in xbuf's dtype (bf16 on the card, round to nearest).
// Pad rows all aim at the scratch row and carry zero leaves, so the blocks
// racing on it write identical zero rows: a benign race, by design.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxD = 16384;

__global__ void __launch_bounds__(kThreads)
decode_to_slots_kernel(void* xbuf, int is_bf16, int cap1, int d,
                       const int* slots, int kind, int k,
                       const void* values, const int* indices,
                       const float* header) {
  extern __shared__ float rowbuf[];             // d
  __shared__ int warp_sums[33];
  const long long r = blockIdx.x;
  const int slot = slots[r];
  const float* vals = static_cast<const float*>(values);
  const int* codes = static_cast<const int*>(values);
  for (int i = threadIdx.x; i < d; i += blockDim.x) rowbuf[i] = 0.f;
  __syncthreads();
  float lo = 0.f, step = 0.f;
  if (kind == repro::kQuant || kind == repro::kSparseQuant) {
    lo = header[r * 2];
    step = header[r * 2 + 1];
  }
  if (kind == repro::kDense) {
    for (int i = threadIdx.x; i < d; i += blockDim.x)
      rowbuf[i] = vals[r * d + i];
  } else if (kind == repro::kSlice) {
    for (int i = threadIdx.x; i < k; i += blockDim.x)
      rowbuf[i] = vals[r * k + i];
  } else if (kind == repro::kQuant) {
    for (int i = threadIdx.x; i < d; i += blockDim.x)
      rowbuf[i] = repro::dequant(codes[r * d + i], lo, step);
  } else if (kind == repro::kSparse || kind == repro::kSparseQuant) {
    for (int j = threadIdx.x; j < k; j += blockDim.x) {
      const int at = indices[r * k + j];
      if (at < 0 || at >= d) continue;
      const float v = kind == repro::kSparse
                          ? vals[r * k + j]
                          : repro::dequant(codes[r * k + j], lo, step);
      atomicAdd(&rowbuf[at], v);
    }
  } else if (kind == repro::kMask) {
    const int nw = (d + 31) >> 5;
    const unsigned* words = reinterpret_cast<const unsigned*>(indices) +
                            r * nw;
    int running = 0;
    for (int base = 0; base < d; base += blockDim.x) {
      const int i = base + threadIdx.x;
      const bool bit = i < d && ((words[i >> 5] >> (i & 31)) & 1u);
      int total;
      const int pos =
          running + repro::block_excl_prefix(bit, warp_sums, &total);
      if (bit && pos < k) rowbuf[i] = vals[r * k + pos];
      running += total;
    }
  }
  __syncthreads();
  if (slot < 0 || slot >= cap1) return;
  const long long out = static_cast<long long>(slot) * d;
  if (is_bf16) {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(xbuf) + out;
    for (int i = threadIdx.x; i < d; i += blockDim.x)
      o[i] = __float2bfloat16_rn(rowbuf[i]);
  } else {
    float* o = static_cast<float*>(xbuf) + out;
    for (int i = threadIdx.x; i < d; i += blockDim.x) o[i] = rowbuf[i];
  }
}

}  // namespace

// xbuf: (cap1, d) f32/bf16, written in place; slots: (n,) int32; leaves of
// the kind, leading dim n: values f32 (dense/slice/sparse/mask) or int32
// codes (quant kinds), indices int32 (sparse kinds) or u32 mask words,
// header (n, 2) f32 (quant kinds). Requires d <= 16384.
extern "C" int decode_to_slots(void* xbuf, int is_bf16, int cap1, int d,
                               const void* slots, int n, int kind, int k,
                               const void* values, const void* indices,
                               const void* header, void* stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaFuncSetAttribute(decode_to_slots_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kMaxD * static_cast<int>(sizeof(float)));
    attr_set = true;
  }
  decode_to_slots_kernel<<<n, kThreads, d * sizeof(float),
                           static_cast<cudaStream_t>(stream)>>>(
      xbuf, is_bf16, cap1, d, static_cast<const int*>(slots), kind, k,
      values, static_cast<const int*>(indices),
      static_cast<const float*>(header));
  return static_cast<int>(cudaGetLastError());
}
