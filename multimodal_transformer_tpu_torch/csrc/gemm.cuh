// Building blocks of the training kernels (csrc/encoder_train.cu,
// csrc/mfn_train.cu): dropout by the fmix32 keep bit, a strided FMA GEMM
// with a fused epilogue, a deterministic split-K reduction and a
// deterministic column sum.
//
// Determinism: Hopper blocks run in any order, so no block ever adds into
// memory that another block writes.  A product whose reduction axis is long
// (a weight gradient sums over every row of the batch) is cut into fixed
// chunks; each chunk's block writes its own partial, and a second pass adds
// the partials in chunk order.  The same inputs give the same bits.
//
// Accuracy: the long sequential sums (partials, column sums over B*T rows)
// are compensated (Kahan), so their error does not grow with the row count.
#pragma once

#include "common.cuh"

namespace mmtx {

// Dropout of one value: keep (hash >= threshold) ? v / keep_p : 0.  The
// threshold is min(round(p * 2^32), 2^32 - 1), computed on the host; p = 0
// gives threshold 0, so every value is kept and divided by 1 exactly.
// The stream (common.cuh DropBits) is chosen at run time.
struct DropSite : DropBits {
  float keep_p;
  __device__ __forceinline__ float apply(float v, uint32_t idx) const {
    return keep(idx) ? v / keep_p : 0.f;
  }
  __device__ __forceinline__ float apply_at(float v, uint32_t row, uint32_t col,
                                            uint32_t width) const {
    return keep_at(row, col, width) ? v / keep_p : 0.f;
  }
};

// The row of probability (qi, *) of head hd of video b in the JAX
// package's [B, h, T, T] tensor, as [B * h * T, T] rows: its dropout keep
// bit is the site's at (prob_row, kj) of width T.
__device__ __forceinline__ uint32_t prob_row(int b, int H, int hd, int Tlen, int qi) {
  return ((uint32_t)b * H + hd) * (uint32_t)Tlen + (uint32_t)qi;
}

// Compensated summation: s + comp carries the running sum's lost bits.
struct KahanSum {
  float s = 0.f, comp = 0.f;
  __device__ __forceinline__ void add(float v) {
    const float y = v - comp;
    const float t = s + y;
    comp = (t - s) - y;
    s = t;
  }
};

constexpr int GBM = 64, GBN = 64, GBK = 16, kGemmThreads2 = 256;

// C[m, n] = sum_k A(m, k) * B(k, n) over k in this block's chunk, with
// A(m, k) = A[m * sam + k * sak] and B(k, n) = B[k * sbk + n * sbn]; then
// epi(m, n, z, acc) with z = blockIdx.z, the chunk.  64x64 tiles, 16-deep
// k steps through shared memory, 4x4 outputs per thread, fp32 accumulation
// on the FMA pipes.  Loads run along whichever index is contiguous.
template <typename TA, typename TB, typename Epi>
__global__ void __launch_bounds__(kGemmThreads2)
gemm_strided_kernel(const TA* __restrict__ A, long long sam, long long sak,
                    const TB* __restrict__ B, long long sbk, long long sbn,
                    int M, int N, int K, int k_chunk, Epi epi) {
  __shared__ float As[GBK][GBM + 4];
  __shared__ float Bs[GBK][GBN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  const int z = blockIdx.z;
  const int kb = z * k_chunk, ke = min(K, kb + k_chunk);
  const bool a_k_contig = sak == 1, b_k_contig = sbk == 1;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += GBK) {
#pragma unroll
    for (int l = 0; l < (GBM * GBK) / kGemmThreads2; ++l) {
      const int idx = tid + l * kGemmThreads2;
      int r, kk;
      if (a_k_contig) { r = idx / GBK; kk = idx % GBK; } else { kk = idx / GBM; r = idx % GBM; }
      const int gm = m0 + r, gk = k0 + kk;
      As[kk][r] = (gm < M && gk < ke) ? to_f(A[(long long)gm * sam + (long long)gk * sak]) : 0.f;
      int c, kc;
      if (b_k_contig) { c = idx / GBK; kc = idx % GBK; } else { kc = idx / GBN; c = idx % GBN; }
      const int gn = n0 + c, gk2 = k0 + kc;
      Bs[kc][c] = (gn < N && gk2 < ke) ? to_f(B[(long long)gk2 * sbk + (long long)gn * sbn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) epi(m, n, z, acc[i][j]);
    }
  }
}

template <typename TA, typename TB, typename Epi>
void gemm_strided(const TA* A, long long sam, long long sak, const TB* B,
                  long long sbk, long long sbn, int M, int N, int K, int splits,
                  Epi epi, cudaStream_t st) {
  const int chunk = ((K + splits - 1) / splits + GBK - 1) / GBK * GBK;
  const int nz = (K + chunk - 1) / chunk;
  dim3 grid((N + GBN - 1) / GBN, (M + GBM - 1) / GBM, nz > 0 ? nz : 1);
  gemm_strided_kernel<TA, TB, Epi><<<grid, kGemmThreads2, 0, st>>>(
      A, sam, sak, B, sbk, sbn, M, N, K, chunk > 0 ? chunk : GBK, epi);
}

// Epilogue that writes chunk z's partial sums to part[z][m][n].
struct PartialStore {
  float* part;
  int N;
  long long plane;
  __device__ __forceinline__ void operator()(int m, int n, int z, float acc) const {
    part[z * plane + (long long)m * N + n] = acc;
  }
};

// out[i] = sum over z in order of part[z][i]  (i < n).  static: this
// header is included by several translation units.
static __global__ void sum_partials_kernel(const float* __restrict__ part, int nz,
                                    long long n, float* __restrict__ out) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  KahanSum s;
  for (int z = 0; z < nz; ++z) s.add(part[z * n + i]);
  out[i] = s.s;
}

// Number of k chunks a weight-gradient product over `rows` rows is cut into.
inline int grad_splits(int rows) {
  const int s = (rows + 255) / 256;
  return s < 1 ? 1 : (s > 32 ? 32 : s);
}

// dW[n, k] = sum_m G(m, n) * X(m, k), with G(m, n) = G[m * ldg + n] and
// X(m, k) = X[m * ldx + k]: a weight gradient in torch's [out, in] layout.
// Deterministic: fixed chunks of rows, partials added in chunk order.
// `part` holds at least grad_splits(M) * N * Kin floats.
template <typename TG, typename TX>
void weight_grad(const TG* G, int ldg, const TX* X, int ldx, int M, int N, int Kin,
                 float* dW, float* part, cudaStream_t st) {
  const int splits = grad_splits(M);
  const int chunk = ((M + splits - 1) / splits + GBK - 1) / GBK * GBK;
  const int nz = (M + chunk - 1) / chunk;
  PartialStore ps{part, Kin, (long long)N * Kin};
  gemm_strided<TG, TX>(G, 1, ldg, X, ldx, 1, N, Kin, M, splits, ps, st);
  const long long n = (long long)N * Kin;
  sum_partials_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(part, nz, n, dW);
}

// out[n] = sum over rows m in order of X[m * ld + n]: 32 columns per block,
// 8 fixed row groups per column (compensated sums), the groups added in
// order.
template <typename T>
__global__ void colsum_kernel(const T* __restrict__ X, int ld, int M, int N,
                              float* __restrict__ out) {
  __shared__ float red[8][33];
  const int c = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int n = blockIdx.x * 32 + c;
  KahanSum s;
  if (n < N)
    for (int m = g; m < M; m += 8) s.add(to_f(X[(long long)m * ld + n]));
  red[g][c] = s.s;
  __syncthreads();
  if (g == 0 && n < N) {
    KahanSum t;
#pragma unroll
    for (int k = 0; k < 8; ++k) t.add(red[k][c]);
    out[n] = t.s;
  }
}

template <typename T>
void colsum(const T* X, int ld, int M, int N, float* out, cudaStream_t st) {
  colsum_kernel<T><<<(N + 31) / 32, 256, 0, st>>>(X, ld, M, N, out);
}

// Carves aligned pieces out of one workspace allocation.
struct Carver {
  char* p;
  size_t used = 0;
  template <typename T> T* take(size_t n) {
    used = (used + 255) / 256 * 256;
    T* out = reinterpret_cast<T*>(p == nullptr ? nullptr : p + used);
    used += n * sizeof(T);
    return out;
  }
};

}  // namespace mmtx
