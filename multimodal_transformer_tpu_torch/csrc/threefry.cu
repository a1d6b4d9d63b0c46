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
// _threefry_random_bits_partitionable): (y0, y1) = threefry2x32(key_k,
// (j >> 32, j & 0xFFFFFFFF)), bits = y0 ^ y1.  Mode kBits stores the bits;
// mode kKeep stores uniform < keep as one byte, uniform being
// jax.random.uniform's float: ((bits >> 9) | 0x3F800000) as a float minus 1.
//
// Bound: the integer pipes.  Each element costs ~80 integer operations
// (20 rounds of add, rotate, xor; 17 key-schedule adds; the output xor; the
// threshold's shift, or, subtract and compare) against 1 or 4 bytes
// stored.  One thread per element, keys in the kernel's parameters (no
// upload), blockIdx.y the key: a simple right kernel first.
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

template <int MODE>
__global__ void __launch_bounds__(kThreads)
threefry_kernel(const Keys keys, long long n, float keep, void* out) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;
  const int k = blockIdx.y;
  const uint32_t b = bits(keys.k[k][0], keys.k[k][1], (uint32_t)(j >> 32),
                          (uint32_t)j);
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
// parameters); out: [K, n] uint32 (mode 0) or uint8 (mode 1) on the card.
// One launch.  Returns cudaGetLastError() after it.
extern "C" int mmtx_threefry(const uint32_t* keys, int K, long long n, int mode,
                             float keep, void* out, void* stream) {
  using namespace threefry;
  if (K < 1 || K > kMaxKeys || n < 1 || (mode != kBits && mode != kKeep))
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
  if (mode == kBits)
    threefry_kernel<kBits><<<grid, kThreads, 0, st>>>(ks, n, keep, out);
  else
    threefry_kernel<kKeep><<<grid, kThreads, 0, st>>>(ks, n, keep, out);
  return (int)cudaGetLastError();
}
