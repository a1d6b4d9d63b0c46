// Kernel P: the bits of jax.random under rbg keys (jax_default_prng_impl =
// "rbg", the JAX CLI's --fast_rng), XLA's Philox4x32-10 expansion of
// lax.rng_bit_generator, over a range of counters, for up to kMaxKeys keys
// in one launch (ops/cuda/philox.py splits more).
//
// Replaces no TPU kernel: the JAX package draws these bits in XLA.  It is
// to rbg keys what kernel T (csrc/threefry.cu) is to threefry keys: the
// port draws the initial weights' uniform bits and, on the "threefry"
// dropout route, every site's bernoulli mask with it.
//
// The draw of m elements under the u32[4] key (k0, k1, k2, k3) (utils/
// prng.py philox_bits_plain, held to jax.random.bits): with s0 = k0 | k1 <<
// 32 and s1 = k2 | k3 << 32, counter i is the 128-bit value whose low half
// is s1 + i (mod 2**64) and whose high half is s0 plus that sum's carry, as
// the words (lo, hi of the low half, lo, hi of the high half); Philox4x32-10
// of it under the key (k0, k1) gives words 4i..4i+3 of the flat draw.
// Element e of the draw is word e % 4 of counter e / 4; the tail of the last
// counter is dropped.
//
// The elements: element j of the output draws element c(j) = start + (j /
// seg_len) * seg_stride + j % seg_len of the draw, as kernel T's counters,
// so that a data-parallel rank draws its rows of a global draw (one
// segment from r0 * (elements per row)) and its part of a time-major site
// (T segments).  One thread a counter that a segment touches: it computes
// the counter's four words once and stores those of the segment's elements
// (1 to 4), so no counter is computed twice within a segment.  Mode kBits
// stores the bits; mode kKeep stores uniform < keep as one byte, uniform
// being jax.random.uniform's ((bits >> 9) | 0x3F800000) as a float minus 1.
//
// Bound: the integer pipes (ten rounds of two 32x32 -> 64 multiplies, xors
// and key adds a counter, against at most 16 bytes stored), taken from the
// SASS (chip_smoke.py sass_int_ops), as kernel T's.  Keys in the kernel's
// parameters, blockIdx.y the key: a simple right kernel first.
#include <cuda_runtime.h>
#include <stdint.h>

namespace philox {

constexpr int kMaxKeys = 240;  // 3,840 bytes of keys within the 4 KB of parameters
constexpr int kThreads = 256;
enum Mode : int { kBits = 0, kKeep = 1 };

struct Keys {
  uint32_t k[kMaxKeys][4];
};

// Philox4x32-10 of counter words x under key (k0, k1), as XLA's Philox4x32.
__device__ __forceinline__ void rounds(uint32_t k0, uint32_t k1, uint32_t (&x)[4]) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(x[0], 0xD2511F53u), lo0 = x[0] * 0xD2511F53u;
    const uint32_t hi1 = __umulhi(x[2], 0xCD9E8D57u), lo1 = x[2] * 0xCD9E8D57u;
    const uint32_t y0 = hi1 ^ x[1] ^ k0, y2 = hi0 ^ x[3] ^ k1;
    x[0] = y0;
    x[1] = lo1;
    x[2] = y2;
    x[3] = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
}

template <int MODE>
__device__ __forceinline__ void put(void* out, long long at, uint32_t b, float keep) {
  if (MODE == kBits) {
    static_cast<uint32_t*>(out)[at] = b;
  } else {
    const float u = __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
    static_cast<uint8_t*>(out)[at] = u < keep ? 1 : 0;
  }
}

// Thread w: segment w / per_seg, that segment's counter w % per_seg
// (per_seg: the most counters a segment touches).  SEGMENTED: more than one
// segment (a division a thread); otherwise one segment of n from start.
template <int MODE, bool SEGMENTED>
__global__ void __launch_bounds__(kThreads)
philox_kernel(const Keys keys, long long n, float keep, void* out, unsigned long long start,
              unsigned long long seg_len, unsigned long long seg_stride,
              unsigned long long per_seg) {
  const unsigned long long w = (unsigned long long)blockIdx.x * kThreads + threadIdx.x;
  unsigned long long seg = 0, ci = w;
  if (SEGMENTED) {
    seg = w / per_seg;
    ci = w - seg * per_seg;
  }
  const unsigned long long len = SEGMENTED ? seg_len : (unsigned long long)n;
  if (seg * len >= (unsigned long long)n) return;
  // this segment's elements: len, or fewer in the last one
  const unsigned long long m = min(len, (unsigned long long)n - seg * len);
  const unsigned long long a = start + seg * seg_stride;  // its first element
  const unsigned long long ctr = (a >> 2) + ci;
  if (ctr > ((a + m - 1) >> 2)) return;
  const int k = blockIdx.y;
  const uint32_t* kw = keys.k[k];
  const unsigned long long s0 = kw[0] | ((unsigned long long)kw[1] << 32);
  const unsigned long long s1 = kw[2] | ((unsigned long long)kw[3] << 32);
  const unsigned long long lo = s1 + ctr;
  const unsigned long long hi = s0 + (lo < s1 ? 1ull : 0ull);
  uint32_t x[4] = {(uint32_t)lo, (uint32_t)(lo >> 32), (uint32_t)hi, (uint32_t)(hi >> 32)};
  rounds(kw[0], kw[1], x);
  const long long base = (long long)k * n + (long long)(seg * len);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const unsigned long long e = 4 * ctr + q;
    if (e >= a && e < a + m) put<MODE>(out, base + (long long)(e - a), x[q], keep);
  }
}

}  // namespace philox

// keys: K <= kMaxKeys rbg keys (4 words each) on the host (copied into the
// launch's parameters); out: [K, n] uint32 (mode 0) or uint8 (mode 1) on the
// card; start, seg_len >= 1, seg_stride: the elements of the draw (see the
// top; start 0 and seg_len n give 0..n-1).  One launch.  Returns
// cudaGetLastError() after it.
extern "C" int mmtx_philox(const uint32_t* keys, int K, long long n, int mode, float keep,
                           void* out, void* stream, long long start, long long seg_len,
                           long long seg_stride) {
  using namespace philox;
  if (K < 1 || K > kMaxKeys || n < 1 || (mode != kBits && mode != kKeep) || start < 0 ||
      seg_len < 1 || seg_stride < 0)
    return (int)cudaErrorInvalidValue;
  const bool seg = seg_len < n;
  const long long len = seg ? seg_len : n;
  const long long n_seg = (n + len - 1) / len;
  // a segment of len elements touches at most (len + 2) / 4 + 1 counters
  const long long per_seg = (len + 2) / 4 + 1;
  const long long threads = n_seg * per_seg;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Keys ks;
  for (int i = 0; i < K; ++i)
    for (int j = 0; j < 4; ++j) ks.k[i][j] = keys[4 * i + j];
  const dim3 grid((unsigned)blocks, (unsigned)K);
  const unsigned long long s0 = start, l = len, stride = seg_stride, ps = per_seg;
  if (mode == kBits && !seg)
    philox_kernel<kBits, false><<<grid, kThreads, 0, st>>>(ks, n, keep, out, s0, l, stride, ps);
  else if (mode == kBits)
    philox_kernel<kBits, true><<<grid, kThreads, 0, st>>>(ks, n, keep, out, s0, l, stride, ps);
  else if (!seg)
    philox_kernel<kKeep, false><<<grid, kThreads, 0, st>>>(ks, n, keep, out, s0, l, stride, ps);
  else
    philox_kernel<kKeep, true><<<grid, kThreads, 0, st>>>(ks, n, keep, out, s0, l, stride, ps);
  return (int)cudaGetLastError();
}
