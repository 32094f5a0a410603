// Device bit-pack: flat unsigned ints of width 1..32 -> little-endian u32
// words (value i at stream bits [i*w, (i+1)*w), bit j of the stream at bit
// j%32 of word j//32).
//
// Replaces the Pallas kernel `pack_bits_kernel`
// (src/repro/kernels/encode/kernel.py:236, body `_pack_block` :214), which
// ORs each of a 32-value group's lanes into its at most two words with a
// static loop because TPU lanes cannot address other lanes' words.
//
// What bounds it on an H100: on the serving path it packs k = 64 indices
// of 12 bits (d = 4096) into 24 words — 352 bytes in all — so launch
// latency is the whole cost. The design is one thread per OUTPUT word: the
// thread ORs in the at most ceil(32/w) + 1 values that overlap its 32
// bits, so there are no atomics and no cross-thread combining, and the
// writes are coalesced. Words past the last value are zero, so the host's
// cut to ceil(n*w/8) bytes is a suffix cut, as in the reference.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
pack_bits_kernel(const int* vals, long long n, int width, unsigned* out,
                 long long n_words) {
  const long long w = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (w >= n_words) return;
  const long long lo_bit = w * 32;
  const unsigned vmask = width == 32 ? 0xffffffffu : ((1u << width) - 1u);
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

}  // namespace

// vals: (n,) int32 holding unsigned values; out: (ceil(n/32) * width,)
// u32 words. Requires 1 <= width <= 32.
extern "C" int pack_bits(const void* vals, long long n, int width, void* out,
                         void* stream) {
  const long long n_words = (n + 31) / 32 * width;
  const long long blocks = (n_words + kThreads - 1) / kThreads;
  pack_bits_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(vals), n, width, static_cast<unsigned*>(out),
      n_words);
  return static_cast<int>(cudaGetLastError());
}
