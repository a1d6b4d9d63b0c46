// Shared device helpers for the port's kernels: dtype conversion, warp
// reductions, the fmix32 dropout bit.  Every kernel reads fp32 or bf16
// storage and computes in fp32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mmtx {

enum DType : int { kF32 = 0, kBF16 = 1 };

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
// Round to nearest even, as torch's and jnp's casts to bf16 do.
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

// murmur3 fmix32 over the position counter with the seed injected up front:
// the same bits as the JAX package's ops/basic.py hash_keep_mask.  uint32
// arithmetic wraps exactly as the JAX uint32 ops do.
__device__ __forceinline__ uint32_t fmix_hash(uint32_t idx, uint32_t seed) {
  uint32_t h = idx * 0x9E3779B1u + seed;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// Dropout of one value on the wgmma paths: keep (the fmix32 bit at its
// position) ? v scale : 0, with scale = 1 / keep_p in fp32 (a multiply, not
// a division per value).
struct Drop {
  uint32_t seed, threshold;
  float scale;
  __device__ __forceinline__ bool keep(uint32_t idx) const {
    return fmix_hash(idx, seed) >= threshold;
  }
  __device__ __forceinline__ float apply(float v, uint32_t idx) const {
    return keep(idx) ? v * scale : 0.f;
  }
};

// Asynchronous global -> shared copy of BYTES (4, 8 or 16) bytes, aligned
// to BYTES on both sides; zero-fills when !pred.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(d), "l"(src), "n"(BYTES), "r"(pred ? BYTES : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// c += a . b on the tensor cores: m16n8k16, bf16 inputs, fp32 accumulation.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace mmtx
