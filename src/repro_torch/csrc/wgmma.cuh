// Hopper warpgroup matrix multiply (wgmma) and cp.async helpers for the
// bf16 attention kernel (header only, sm_90a).
//
// One shape is used, m64n64k16 bf16 x bf16 -> f32: 64 rows of A (one
// warpgroup, 16 rows per warp), 64 columns of B, 16 deep. The 32 f32
// accumulators of a thread hold, for n8 block j = i / 4 of the tile,
//   d[4j], d[4j + 1]:     row 16 warp + lane / 4, cols 8j + 2 (lane % 4)
//                         and the one after it;
//   d[4j + 2], d[4j + 3]: row 16 warp + lane / 4 + 8, the same cols
// (the PTX ISA's wgmma D fragment layout). An A fragment held in registers
// is four b32 words of two bf16 each, in the same rows and
// cols {2 (lane % 4), +1} and {+8, +9} of the 16-deep slice: words 0 and 2
// on the first row, 1 and 3 on the second.
//
// Shared-memory operands are read through 64-bit matrix descriptors. Every
// tile here is stored in the 128-byte swizzle (layout type 1): 64 bf16 (128
// bytes) per row, the 16-byte unit u of row r at unit u ^ (r % 8), 8-row
// groups 1024 bytes apart, tiles 1024-byte aligned; a matrix wider than 64
// columns is several such tiles side by side (`swizzle_offset`).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace repro {
namespace wg {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (r, c) of a bf16 matrix of `rows` rows stored as
// column chunks of 64, each chunk `rows` x 128 bytes in the 128-byte
// swizzle.
__device__ __forceinline__ uint32_t swizzle_offset(int rows, int r, int c) {
  return static_cast<uint32_t>((c >> 6) * rows * 128 + r * 128 +
                               ((((c >> 3) & 7) ^ (r & 7)) << 4) +
                               ((c & 7) << 1));
}

// Matrix descriptor: start address, leading and stride byte offsets (both
// in bytes here, encoded in 16-byte units), 128-byte swizzle.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of accumulators across the
// asynchronous wgmma (issue ... wait).
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A (64 x 16 from registers, `a` as above) . B (16 x 64) through a
// descriptor: with kTransB = 0 B's rows are its 64 columns, K-major (16
// contiguous reduction elements each); with kTransB = 1 B is MN-major: its
// 16 rows are the reduction, each of 64 contiguous columns.
template <int kTransB>
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(kTransB));
}

// 16-byte asynchronous copy global -> shared; `ok` false zero-fills.
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Make this thread's shared-memory writes (cp.async included) visible to
// the async proxy that wgmma reads through; a barrier follows.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

}  // namespace wg
}  // namespace repro
