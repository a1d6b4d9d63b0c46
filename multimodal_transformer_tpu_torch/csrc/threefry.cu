// Kernel T: jax.random's threefry2x32 bits over a flat range of counters,
// for up to kMaxKeys keys in one launch (ops/cuda/threefry.py splits more).
//
// Replaces no TPU kernel: the JAX package draws its initial weights and its
// "threefry" dropout masks with jax.random (XLA, not Pallas).  The port
// draws the same bits on the card here: uniform weights from the bits, and
// the keep masks of jax.random.bernoulli at every dropout site of the
// threefry route (the [B, h, T, T] attention probabilities are 6.55 M
// elements a layer at B = 32, T = 160, where a torch program would run
// ~120 int64 passes).
//
// Element j of key k (JAX's "partitionable" path, jax/_src/prng.py
// _threefry_random_bits_partitionable) draws counter c(j): (y0, y1) =
// threefry2x32(key_k, (c >> 32, c & 0xFFFFFFFF)), bits = y0 ^ y1.  Mode
// kBits stores the bits; mode kKeep stores uniform < keep as one byte,
// uniform being jax.random.uniform's float: ((bits >> 9) | 0x3F800000) as a
// float minus 1.
//
// The counters: c(j) = start + (j / seg_len) * seg_stride + j % seg_len.
// With start 0 and one segment of n (the defaults) c(j) = j, the draw over
// the flat positions 0..n-1 of a shape.  Since the bits at a flat position
// depend only on the key and the position, a data-parallel rank draws its
// rows of a global draw by its counters alone: rows [r0, r0 + local) of a
// batch-major [rows, ...] site are one segment starting at r0 * (elements
// per row); rank r's [T, local, W] part of a time-major [T, rows, W] site
// is T segments of local * W counters at stride rows * W from r0 * W.
//
// Bound: the integer pipes.  Each element is 20 rounds of add, rotate,
// xor, the key schedule's adds, the output xor and the threshold, against
// 1 or 4 bytes stored; the compiler merges key adds into the rounds' adds
// (IADD3) and puts adds on the FMA pipe beside the ALU's rotates and xors,
// so the bound is taken from the SASS (chip_smoke.py sass_int_ops).  One
// thread per element, keys in the kernel's parameters (no upload),
// blockIdx.y the key: a simple right kernel first.
#include <cuda_runtime.h>
#include <stdint.h>

namespace threefry {

constexpr int kMaxKeys = 480;  // 3,840 bytes of keys within the 4 KB of parameters
constexpr int kThreads = 256;
enum Mode : int { kBits = 0, kKeep = 1 };

struct Keys {
  uint32_t k[kMaxKeys][2];
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return __funnelshift_l(x, x, d);
}

#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r) ^ x0;

__device__ __forceinline__ uint32_t bits(uint32_t k0, uint32_t k1, uint32_t x0,
                                         uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
  return x0 ^ x1;
}

#undef TF_ROUND

// SEGMENTED: more than one segment (a division a element); otherwise
// c(j) = start + j.
template <int MODE, bool SEGMENTED>
__global__ void __launch_bounds__(kThreads)
threefry_kernel(const Keys keys, long long n, float keep, void* out,
                unsigned long long start, unsigned long long seg_len,
                unsigned long long seg_stride) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;
  const int k = blockIdx.y;
  unsigned long long c = start + (unsigned long long)j;
  if (SEGMENTED) {
    const unsigned long long seg = (unsigned long long)j / seg_len;
    c = start + seg * seg_stride + ((unsigned long long)j - seg * seg_len);
  }
  const uint32_t b = bits(keys.k[k][0], keys.k[k][1], (uint32_t)(c >> 32),
                          (uint32_t)c);
  const long long at = (long long)k * n + j;
  if (MODE == kBits) {
    static_cast<uint32_t*>(out)[at] = b;
  } else {
    const float u = __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
    static_cast<uint8_t*>(out)[at] = u < keep ? 1 : 0;
  }
}

}  // namespace threefry

// keys: K <= kMaxKeys pairs on the host (copied into the launch's
// parameters); out: [K, n] uint32 (mode 0) or uint8 (mode 1) on the card;
// start, seg_len >= 1, seg_stride: the counters (see the top; start 0 and
// seg_len n give 0..n-1).  One launch.  Returns cudaGetLastError() after it.
extern "C" int mmtx_threefry(const uint32_t* keys, int K, long long n,
                             int mode, float keep, void* out, void* stream,
                             long long start, long long seg_len,
                             long long seg_stride) {
  using namespace threefry;
  if (K < 1 || K > kMaxKeys || n < 1 || (mode != kBits && mode != kKeep) ||
      start < 0 || seg_len < 1 || seg_stride < 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Keys ks;
  for (int i = 0; i < K; ++i) {
    ks.k[i][0] = keys[2 * i];
    ks.k[i][1] = keys[2 * i + 1];
  }
  const dim3 grid((unsigned)blocks, (unsigned)K);
  const unsigned long long s0 = start, len = seg_len, stride = seg_stride;
  const bool seg = seg_len < n;
  if (mode == kBits && !seg)
    threefry_kernel<kBits, false><<<grid, kThreads, 0, st>>>(ks, n, keep, out,
                                                            s0, len, stride);
  else if (mode == kBits)
    threefry_kernel<kBits, true><<<grid, kThreads, 0, st>>>(ks, n, keep, out,
                                                           s0, len, stride);
  else if (!seg)
    threefry_kernel<kKeep, false><<<grid, kThreads, 0, st>>>(ks, n, keep, out,
                                                            s0, len, stride);
  else
    threefry_kernel<kKeep, true><<<grid, kThreads, 0, st>>>(ks, n, keep, out,
                                                           s0, len, stride);
  return (int)cudaGetLastError();
}
