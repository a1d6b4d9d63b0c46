// Row-block helpers of the kernels that keep 64 rows a block in one
// warpgroup's wgmma accumulators (kernel A's bf16 path in encoder.cu, the
// encoder backward's bf16 path in encoder_bwd.cu): the thread's place in
// the accumulator layout, LayerNorm of rows held in that layout rounded
// into wgmma A fragments, swizzled tile loads, and the host's TMA maps of
// weights and of per-head boxes.  sm_90a only.
#pragma once

#include <functional>
#include <mutex>
#include <unordered_map>

#include "hopper.cuh"

namespace mmtx {
namespace wg {

using namespace ::mmtx::sm90;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // one warpgroup
constexpr int BM = 64;         // rows of a block

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The thread's place in a 64-row block: warp w owns rows 16 w + g and
// 16 w + g + 8 (g = lane / 4); of every 128-column pass p it holds the
// columns 128 p + 8 j + 2 t and + 1 (t = lane % 4, j < 16) of both rows.
// That is wgmma's accumulator layout: v[p][4 j + e] at row 0, v[p][4 j + 2
// + e] at row 1, column 128 p + 8 j + 2 t + e (a 64-column pass holds the
// first 32 of these).  Read as 16-column k steps ks = 8 p + j / 2, the same
// values are wgmma's A fragment (RS): a[ks][2 (j % 2) + rr] holds the pair
// of row rr.  A row's D values lie with the 4 threads of a quad, so its
// statistics are two shuffles.
struct Rows {
  int r0, t;  // the thread's first row in the block (the second is r0 + 8), t
  __device__ Rows() {
    const int lane = threadIdx.x % 32;
    r0 = 16 * (threadIdx.x / 32) + lane / 4;
    t = lane % 4;
  }
};

// v[p][...] from the residual rows in shared memory (row stride RS).
template <int NP>
__device__ __forceinline__ void read_rows(float (&v)[NP][64], const float* res, int RS,
                                          const Rows& rw) {
  const float* x0 = res + rw.r0 * RS + 2 * rw.t;
  const float* x1 = x0 + 8 * RS;
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 u = *reinterpret_cast<const float2*>(x0 + 128 * p + 8 * j);
      const float2 w = *reinterpret_cast<const float2*>(x1 + 128 * p + 8 * j);
      v[p][4 * j] = u.x;
      v[p][4 * j + 1] = u.y;
      v[p][4 * j + 2] = w.x;
      v[p][4 * j + 3] = w.y;
    }
}

// The mean and unbiased variance of the two rows over their D = 128 NP
// values (quad order).
template <int NP>
__device__ __forceinline__ void row_stats(const float (&v)[NP][64], float& mean0,
                                          float& mean1, float& var0, float& var1) {
  constexpr float D = 128.f * NP;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      s0 += v[p][4 * j] + v[p][4 * j + 1];
      s1 += v[p][4 * j + 2] + v[p][4 * j + 3];
    }
  mean0 = quad_sum(s0) / D;
  mean1 = quad_sum(s1) / D;
  float q0 = 0.f, q1 = 0.f;
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const float d = v[p][i] - ((i & 2) ? mean1 : mean0);
      if (i & 2) q1 += d * d; else q0 += d * d;
    }
  var0 = quad_sum(q0) / (D - 1.f);
  var1 = quad_sum(q1) / (D - 1.f);
}

// The quirky LN of the two rows over their D = 128 NP values: v becomes
// a (v - mean) (1 / (std_unbiased + 1e-6)) + b (one division a row); mean
// and var: the rows' statistics.
template <int NP>
__device__ __forceinline__ void layer_norm(float (&v)[NP][64], const bf16* ga,
                                           const bf16* gb, int t, float (&mean)[2],
                                           float (&var)[2]) {
  row_stats(v, mean[0], mean[1], var[0], var[1]);
  const float inv0 = 1.f / (sqrtf(var[0]) + 1e-6f);
  const float inv1 = 1.f / (sqrtf(var[1]) + 1e-6f);
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 128 * p + 8 * j + 2 * t;
      const float2 a = load_pair(ga + c), b = load_pair(gb + c);
      v[p][4 * j] = a.x * (v[p][4 * j] - mean[0]) * inv0 + b.x;
      v[p][4 * j + 1] = a.y * (v[p][4 * j + 1] - mean[0]) * inv0 + b.y;
      v[p][4 * j + 2] = a.x * (v[p][4 * j + 2] - mean[1]) * inv1 + b.x;
      v[p][4 * j + 3] = a.y * (v[p][4 * j + 3] - mean[1]) * inv1 + b.y;
    }
}
template <int NP>
__device__ __forceinline__ void layer_norm(float (&v)[NP][64], const bf16* ga,
                                           const bf16* gb, int t) {
  float mean[2], var[2];
  layer_norm(v, ga, gb, t, mean, var);
}

// v in the accumulator layout rounded to bf16 as the A fragments of its
// 8 NP k steps.
template <int NP>
__device__ __forceinline__ void to_frags(const float (&v)[NP][64], uint32_t (&a)[8 * NP][4]) {
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      a[8 * p + j / 2][2 * (j % 2)] = pack_bf16(v[p][4 * j], v[p][4 * j + 1]);
      a[8 * p + j / 2][2 * (j % 2) + 1] = pack_bf16(v[p][4 * j + 2], v[p][4 * j + 3]);
    }
}

// 64 rows x D bf16 (row stride D) by cp.async into D / 64 chunks of 64 rows
// x 128 bytes; 16-byte group c of row r lands at group c ^ (r % 8), the
// 128-byte swizzle wgmma reads.  Rows at or past `valid` are zeros.
template <int D>
__device__ __forceinline__ void load_swizzled(uint8_t* dst, const bf16* src, int valid) {
  constexpr int G = D / 8;  // 16-byte groups a row
  for (int i = threadIdx.x; i < BM * G; i += kThreads) {
    const int r = i / G, gk = i % G;
    const bool ok = r < valid;
    cp_async<16>(dst + (gk / 8) * (BM * 128) + r * 128 + (((gk % 8) ^ (r % 8)) << 4),
                 src + (size_t)(ok ? r : 0) * D + 8 * gk, ok);
  }
}

// The TMA map of a bf16 matrix W [rows, cols] (boxes of 64 columns x
// box_rows rows, 128-byte swizzle), encoded once per (W, rows, cols,
// box_rows): a map holds only an address and a layout, so it stays right
// for any tensor there.
inline bool tile_map(CUtensorMap* map, const bf16* W, int rows, int cols, int box_rows) {
  struct Key {
    const void* p;
    int rows, cols, box;
    bool operator==(const Key& o) const {
      return p == o.p && rows == o.rows && cols == o.cols && box == o.box;
    }
  };
  struct Hash {
    size_t operator()(const Key& k) const {
      return std::hash<const void*>()(k.p) ^ ((size_t)k.rows << 20) ^ ((size_t)k.cols << 4) ^
             ((size_t)k.box << 40);
    }
  };
  static std::mutex mu;
  static std::unordered_map<Key, CUtensorMap, Hash> cache;
  std::lock_guard<std::mutex> lock(mu);
  const Key key{W, rows, cols, box_rows};
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return true;
  }
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  if (fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(W), dims, strides, box,
         elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *map);
  return true;
}

// The map of per-head boxes of a bf16 [B, T, width] tensor, dims innermost
// first: one box is 64 rows (time steps) of one head's DK columns,
// swizzled over its DK * 2-byte rows (64B at DK = 32, 32B at 16).
inline bool heads_map(CUtensorMap* map, const void* base, int B, int T, int width, int DK) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)width * 2, (cuuint64_t)T * width * 2};
  const cuuint32_t box[3] = {(cuuint32_t)DK, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            DK == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace wg
}  // namespace mmtx
