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

// The "hash4" stream's keep bit of (row, col) at a site of last axis
// 4 * w4 (the JAX package's ops/basic.py hash4_keep_rows): column c of
// block k = c / w4 takes byte k of fmix32(row * w4 + c % w4), kept when it
// is at least the 8-bit threshold t8.  The block comes from three compares,
// not a division.  Columns past the site (padded keys) alias other
// counters; the kernels never keep their values.
__device__ __forceinline__ bool hash4_keep(uint32_t seed, uint32_t w4, uint32_t t8,
                                           uint32_t row, uint32_t col) {
  const uint32_t k = (uint32_t)(col >= w4) + (uint32_t)(col >= 2 * w4) +
                     (uint32_t)(col >= 3 * w4);
  const uint32_t h = fmix_hash(row * w4 + (col - k * w4), seed);
  return ((h >> (8 * k)) & 0xFFu) >= t8;
}

// A site's hash4 quarter width: width / 4 on the "hash4" stream (t8 >= 0)
// where width % 4 == 0, else 0, the per-element fmix32 bits of the "hash"
// stream (which a hash4 site of another width falls back to).
__host__ __device__ __forceinline__ uint32_t hash4_w4(int t8, int width) {
  return t8 >= 0 && width % 4 == 0 ? (uint32_t)(width / 4) : 0u;
}

// A dropout site's keep bits: the fmix32 bit at a position (the "hash"
// stream), or on the "hash4" stream (w4 > 0) hash4_keep's at (row, col).
// The stream is a template argument of keep_at where a kernel is built for
// one (the wgmma paths), so the other stream's bits cost it nothing.
struct DropBits {
  uint32_t seed, threshold;
  uint32_t w4 = 0, t8 = 0;  // hash4 (hash4_w4); w4 = 0: per-element bits
  // the site of last axis `width` on the stream t8 (hash4_w4)
  static __host__ __device__ DropBits of(uint32_t seed, uint32_t thr, int t8, int width) {
    return DropBits{seed, thr, hash4_w4(t8, width), t8 < 0 ? 0u : (uint32_t)t8};
  }
  __device__ __forceinline__ bool keep(uint32_t idx) const {
    return fmix_hash(idx, seed) >= threshold;
  }
  // the keep bit of (row, col) at a site of last axis `width`: H4 the
  // hash4 bits (w4 > 0), else the per-element bit at row * width + col
  template <bool H4>
  __device__ __forceinline__ bool keep_at(uint32_t row, uint32_t col, uint32_t width) const {
    if constexpr (H4) return hash4_keep(seed, w4, t8, row, col);
    else return keep(row * width + col);
  }
  // the same with the stream chosen at run time by w4
  __device__ __forceinline__ bool keep_at(uint32_t row, uint32_t col, uint32_t width) const {
    return w4 ? keep_at<true>(row, col, width) : keep_at<false>(row, col, width);
  }
};

// Dropout of one value on the wgmma paths: keep ? v * scale : 0, with
// scale = 1 / keep_p in fp32 (a multiply, not a division per value).
struct Drop : DropBits {
  float scale;
  static __host__ __device__ Drop of(uint32_t seed, uint32_t thr, float scale, int t8,
                                     int width) {
    return Drop{DropBits::of(seed, thr, t8, width), scale};
  }
  template <bool H4>
  __device__ __forceinline__ float apply_at(float v, uint32_t row, uint32_t col,
                                            uint32_t width) const {
    return keep_at<H4>(row, col, width) ? v * scale : 0.f;
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
