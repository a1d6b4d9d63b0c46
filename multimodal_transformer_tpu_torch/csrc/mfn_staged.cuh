// The staged MFN kernels' shared pieces: kernel B's stages (csrc/mfn.cu,
// also kernel 6's) and kernel 7's (csrc/mfn_train.cu) read their weights
// through these vector loads, lay them out in shared memory with gather(),
// and run their batched products with ff_gemm_kernel, an fp32 FMA GEMM whose
// epilogue each caller supplies.
#pragma once

#include "mfn_common.cuh"

namespace mmtx {
namespace mfn_staged {

constexpr int kMaxThreads = 1024;
constexpr size_t kSmemMax = 232448;  // per block on sm_90, after the opt-in

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Four neighbouring weights in the storage dtype, read as one vector.
template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<__nv_bfloat16> { using type = uint2; };

__device__ __forceinline__ float4 to_f4(float4 v) { return v; }
__device__ __forceinline__ float4 to_f4(uint2 v) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Lanes per hidden unit in the LSTM scan, H units in a block of `threads`:
// the largest power of two up to kLstmLanes that fits and leaves each lane at
// least four columns.  More lanes shorten each lane's sum but add shuffles,
// and every warp then runs the cell update.  Host and device agree on it.
constexpr int kLstmLanes = 4;
__host__ __device__ inline int lanes_per_unit(int H, int threads) {
  int s = 1;
  while (s < kLstmLanes && H * 2 * s <= threads && 8 * s <= H) s *= 2;
  return s;
}

// Steps of xp rows in flight: the LSTM scan copies them into a ring in
// shared memory with cp.async, kRing - 1 steps ahead.
constexpr int kRing = 8;

// sum over q < n4 of w[q * stride] . x[q], four running sums
template <typename V>
__device__ __forceinline__ float dot4(const V* w, int stride, const float4* x, int n4) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 4
  for (int q = 0; q < n4; ++q) {
    const float4 wv = to_f4(w[q * stride]);
    const float4 xv = x[q];
    s0 = fmaf(wv.x, xv.x, s0);
    s1 = fmaf(wv.y, xv.y, s1);
    s2 = fmaf(wv.z, xv.z, s2);
    s3 = fmaf(wv.w, xv.w, s3);
  }
  return (s0 + s1) + (s2 + s3);
}

// Four neighbouring fp32 products added into two running sums.
__device__ __forceinline__ void fma4(float& s0, float& s1, float4 w, float4 x) {
  s0 = fmaf(w.x, x.x, s0);
  s1 = fmaf(w.y, x.y, s1);
  s0 = fmaf(w.z, x.z, s0);
  s1 = fmaf(w.w, x.w, s1);
}

// Each of v[] summed over `lanes` neighbouring lanes (a power of two, at
// most kLstmLanes): the levels are unrolled, so the N sums' shuffles overlap.
template <int N>
__device__ __forceinline__ void lane_sums(float (&v)[N], int lanes) {
#pragma unroll
  for (int off = 1; off < kLstmLanes; off <<= 1) {
    if (off < lanes) {
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
    }
  }
}

// Zeroes `bytes` (a multiple of 16) of shared memory.
__device__ __forceinline__ void zero_smem(unsigned char* p, size_t bytes) {
  for (size_t i = threadIdx.x; i < bytes / 16; i += blockDim.x)
    reinterpret_cast<float4*>(p)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// dst[dst_of(e)] = src[src_of(e)] for e < n, kBatch loads in flight per
// thread (the weights are read once per block, from L2 or device memory).
template <typename T, typename Src, typename Dst>
__device__ __forceinline__ void gather(const T* __restrict__ src, int n, T* dst, Src src_of,
                                       Dst dst_of) {
  constexpr int kBatch = 8;
  for (int e0 = threadIdx.x; e0 < n; e0 += kBatch * blockDim.x) {
    T v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int e = e0 + k * blockDim.x;
      if (e < n) v[k] = src[src_of(e)];
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int e = e0 + k * blockDim.x;
      if (e < n) dst[dst_of(e)] = v[k];
    }
  }
}

// ---------------------------------------------------------------- batched products

// out[m, n] = act(acc + bias[n]) with row stride ldo.
template <typename T>
struct BiasAct {
  float* out;
  int ldo;
  const T* bias;
  int act;
  __device__ __forceinline__ void operator()(int m, int n, float acc) const {
    out[(size_t)m * ldo + n] = mfn::activate(acc + to_f(bias[n]), act);
  }
};

// One product of a batched stage: C[M, N] = A[M, K] . W[N, K]^T, then
// epi(m, n, acc) for each output.
template <typename T, typename Epi = BiasAct<T>>
struct FfJob {
  const T* w;
  int ldw, N;
  Epi epi;
};

template <typename T, typename Epi>
struct FfJobs {
  FfJob<T, Epi> job[3];
};

constexpr int FBM = 64, FBN = 64, FBK = 16, kFfThreads = 256;

// C = A . W^T for up to three products sharing A (blockIdx.z picks one):
// A fp32 [M, lda], W in the storage dtype [N, ldw], both K-contiguous.  64x64
// tiles, 16-deep k steps double-buffered through shared memory (the next
// step's loads are in registers while this one computes), 4x4 neighbouring
// outputs per thread read as float4 (two shared loads per 16 FMAs).  Each
// output sums k in order: deterministic.
template <typename T, typename Epi>
__global__ void __launch_bounds__(kFfThreads)
ff_gemm_kernel(const float* __restrict__ A, int lda, int M, int K, FfJobs<T, Epi> jobs) {
  __shared__ __align__(16) float As[2][FBK][FBM + 4];
  __shared__ __align__(16) float Ws[2][FBK][FBN + 4];
  const FfJob<T, Epi> jb = jobs.job[blockIdx.z];
  const int m0 = blockIdx.y * FBM, n0 = blockIdx.x * FBN;
  if (n0 >= jb.N) return;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lr = tid >> 2, lk = (tid & 3) * 4;
  const float* a_row = A + (size_t)(m0 + lr) * lda;
  const T* w_row = jb.w + (size_t)(n0 + lr) * jb.ldw;
  const bool a_ok = m0 + lr < M, w_ok = n0 + lr < jb.N;
  float ra[4], rw[4];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gk = k0 + lk + i;
      ra[i] = a_ok && gk < K ? a_row[gk] : 0.f;
      rw[i] = w_ok && gk < K ? to_f(w_row[gk]) : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      As[buf][lk + i][lr] = ra[i];
      Ws[buf][lk + i][lr] = rw[i];
    }
  };
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  load(0);
  store(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += FBK) {
    const bool more = k0 + FBK < K;
    if (more) load(k0 + FBK);
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 wv = *reinterpret_cast<const float4*>(&Ws[buf][kk][tx * 4]);
      const float a4[4] = {av.x, av.y, av.z, av.w}, w4[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a4[i], w4[j], acc[i][j]);
    }
    if (more) store(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int mm = m0 + ty * 4 + i;
    if (mm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nn = n0 + tx * 4 + j;
      if (nn < jb.N) jb.epi(mm, nn, acc[i][j]);
    }
  }
}

// Defined in csrc/mfn.cu, for its C entries, kernel 6's (csrc/mfn_train.cu)
// and rows 8 and 9's (csrc/mfn_variants.cu).  parse fills a's shapes and
// the natural layout from the C arguments, or returns false for shapes the
// stages refuse.  launch runs the three stages on the stream, reading the
// weights and the c workspace in a's layout, and returns the first CUDA
// error: kernel B, or with a.cs set kernel 6 (every c_t stored; the
// gamma-hidden dropout unless both thresholds are 0).  ws:
// mmtx_mfn_scan_workspace bytes for a's c row.
bool parse(mfn::Args& a, int dtype, const void* xp, const void* whh, const void* hid,
           int n_mods, const void* gates, int B, int T, int mem, int h_att1, int h_att2,
           int h_g1, int h_g2);
int launch(const mfn::Args& a, int dtype, void* ws, cudaStream_t st);

template <typename T, typename Epi>
void ff_gemm(const float* A, int lda, int M, int K, const FfJob<T, Epi>* jobs, int n_jobs,
             cudaStream_t st) {
  FfJobs<T, Epi> js{};
  int n_max = 0;
  for (int i = 0; i < n_jobs; ++i) {
    js.job[i] = jobs[i];
    n_max = jobs[i].N > n_max ? jobs[i].N : n_max;
  }
  const dim3 grid((n_max + FBN - 1) / FBN, (M + FBM - 1) / FBM, n_jobs);
  ff_gemm_kernel<T, Epi><<<grid, kFfThreads, 0, st>>>(A, lda, M, K, js);
}

}  // namespace mfn_staged
}  // namespace mmtx
