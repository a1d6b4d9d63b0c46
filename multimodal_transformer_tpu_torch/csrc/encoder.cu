// Kernel A: the N-layer key-masked pre-norm encoder stack plus final norm,
// eval mode.
//
// Replaces: multimodal_transformer_tpu/ops/pallas/encoder.py
//   encoder_stack_fused (body _kernel, _attention_tile, _ln).
//
// Per layer: quirky LN (unbiased std, eps on the std) -> Q, K, V projections
// -> h-head attention with where(key_mask == 0, -1e9) on the keys only -> output
// projection + residual -> quirky LN -> FFN (ReLU) + residual; then a final LN.
// Rounding points follow the TPU kernel: matmul inputs in the storage dtype
// (fp32 or bf16) with fp32 accumulation; LN, softmax and the residual stream
// in fp32; q (pre-scaled by 1/sqrt(d_k)), k, v, the attention output and the
// FFN hidden stored in the storage dtype.
//
// What bounds it on the H100: at MFT shapes (B=32, T=160, D=256, h=8, F=128,
// 6 layers) one stack is ~20 GFLOP of projections and ~5 GFLOP of attention
// against ~0.2 GB of activation traffic, so it is compute-bound.  This first
// version runs every product on the fp32 FMA pipes (67 TFLOP/s peak), not the
// tensor cores, which caps it far below the bf16 peak.
//
// What the design does about it: correctness first.  The TPU kernel kept the
// whole [h*T, T] score block in VMEM, which is why it needed a fit guard;
// here attention is one block per (video, head, 64-query tile) walking the
// key tiles with an online softmax, so every T works and nothing quadratic in
// T is stored.  The products are 64x64 smem-tiled FMA GEMMs with fused bias,
// ReLU, scale and fp32-residual epilogues.  One C entry launches the whole
// stack on the caller's stream, so Python pays one call per stack.  Moving
// the GEMMs and the two attention products onto wgmma is later work.

#include "common.cuh"

namespace mmtx {
namespace enc {

constexpr float kMaskedScore = -1e9f;
constexpr int BM = 64, BN = 64, BK = 16, kGemmThreads = 256;
constexpr int kLnThreads = 256;  // one warp per row

enum Epilogue : int { kStore = 0, kStoreRelu = 1, kResidual = 2 };

// y = a * (x - mean) / (std_unbiased + eps) + b per row of D; optionally
// copies the row to x32 in fp32 (the residual stream's first write).
template <typename Tin, typename Tw, typename Tout>
__global__ void __launch_bounds__(kLnThreads)
ln_rows_kernel(const Tin* __restrict__ x, const Tw* __restrict__ a,
               const Tw* __restrict__ b, Tout* __restrict__ y,
               float* __restrict__ x32, int rows, int D) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warp leaves together
  const Tin* xr = x + (size_t)row * D;
  float s = 0.f;
  for (int i = lane; i < D; i += 32) s += to_f(xr[i]);
  const float mean = warp_sum(s) / (float)D;
  float v = 0.f;
  for (int i = lane; i < D; i += 32) {
    const float d = to_f(xr[i]) - mean;
    v += d * d;
  }
  const float denom = sqrtf(warp_sum(v) / (float)(D - 1)) + 1e-6f;
  for (int i = lane; i < D; i += 32) {
    const float xv = to_f(xr[i]);
    if (x32 != nullptr) x32[(size_t)row * D + i] = xv;
    y[(size_t)row * D + i] = from_f<Tout>(to_f(a[i]) * (xv - mean) / denom + to_f(b[i]));
  }
}

// out[m, n] = epi(A[m, :] . W[n, :] + bias[n]) with W in torch layout [N, K].
//   kStore:     out = alpha * (acc + bias), cast to T
//   kStoreRelu: out = max(acc + bias, 0), cast to T
//   kResidual:  res[m, n] += acc + bias (fp32)
template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
gemm_bias_kernel(const T* __restrict__ A, int lda, const T* __restrict__ W,
                 const T* __restrict__ bias, int M, int N, int K, float alpha,
                 int epi, T* __restrict__ out, int ldo, float* __restrict__ res,
                 int ldr) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Ws[BK][BN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int l = 0; l < (BM * BK) / kGemmThreads; ++l) {
      const int idx = tid + l * kGemmThreads;
      const int r = idx / BK, kk = idx % BK;
      const int gk = k0 + kk, gm = m0 + r, gn = n0 + r;
      As[kk][r] = (gm < M && gk < K) ? to_f(A[(size_t)gm * lda + gk]) : 0.f;
      Ws[kk][r] = (gn < N && gk < K) ? to_f(W[(size_t)gn * K + gk]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Ws[kk][tx + 16 * j];
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
      if (n >= N) continue;
      const float v = acc[i][j] + to_f(bias[n]);
      if (epi == kResidual) {
        res[(size_t)m * ldr + n] += v;
      } else if (epi == kStoreRelu) {
        out[(size_t)m * ldo + n] = from_f<T>(fmaxf(v, 0.f));
      } else {
        out[(size_t)m * ldo + n] = from_f<T>(v * alpha);
      }
    }
  }
}

// One block per (64-query tile, head, video).  qkv rows are [q | k | v], each
// D wide, head `hd` at columns hd*DK; q is already scaled by 1/sqrt(DK).
// TPQ threads share one query row: each scores KT/TPQ keys of a tile and owns
// DK/TPQ output columns.  The softmax runs online over 64-key tiles.
template <typename T, int DK>
__global__ void attention_kernel(const T* __restrict__ qkv,
                                 const float* __restrict__ kmask,
                                 T* __restrict__ out, int Tlen, int D) {
  constexpr int QT = 64, KT = 64;
  constexpr int TPQ = DK >= 4 ? 4 : DK;
  constexpr int NT = QT * TPQ;
  constexpr int KPT = KT / TPQ;
  constexpr int DPT = DK / TPQ;
  __shared__ float Ks[KT][DK + 1];
  __shared__ float Vs[KT][DK + 1];
  __shared__ float Ps[QT][KT + 1];

  const int b = blockIdx.z, hd = blockIdx.y, q0 = blockIdx.x * QT;
  const int tid = threadIdx.x, ql = tid / TPQ, sub = tid % TPQ;
  const int qi = q0 + ql;
  const size_t rs = 3 * (size_t)D;
  const T* base = qkv + (size_t)b * Tlen * rs;
  const float* km = kmask + (size_t)b * Tlen;

  float q[DK];
#pragma unroll
  for (int d = 0; d < DK; ++d)
    q[d] = qi < Tlen ? to_f(base[(size_t)qi * rs + hd * DK + d]) : 0.f;
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;

  for (int k0 = 0; k0 < Tlen; k0 += KT) {
    __syncthreads();  // previous tile's Ks/Vs/Ps fully consumed
    for (int idx = tid; idx < KT * DK; idx += NT) {
      const int j = idx / DK, d = idx % DK, kj = k0 + j;
      const bool ok = kj < Tlen;
      Ks[j][d] = ok ? to_f(base[(size_t)kj * rs + D + hd * DK + d]) : 0.f;
      Vs[j][d] = ok ? to_f(base[(size_t)kj * rs + 2 * D + hd * DK + d]) : 0.f;
    }
    __syncthreads();
    const int nk = min(KT, Tlen - k0);

    float s[KPT];
    float tmax = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const int j = jj * TPQ + sub;
      if (j < nk) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < DK; ++d) dot = fmaf(q[d], Ks[j][d], dot);
        if (km[k0 + j] == 0.f) dot = kMaskedScore;
        s[jj] = dot;
        tmax = fmaxf(tmax, dot);
      } else {
        s[jj] = -INFINITY;
      }
    }
#pragma unroll
    for (int off = 1; off < TPQ; off <<= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
    // nk >= 1, so tmax >= -1e9 is finite and so is m_new.
    const float m_new = fmaxf(m_run, tmax);
    const float scale = expf(m_run - m_new);  // 0 on the first tile
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const int j = jj * TPQ + sub;
      if (j < nk) {
        const float p = expf(s[jj] - m_new);
        psum += p;
        // p @ v takes p in the storage dtype, as the TPU kernel does.
        Ps[ql][j] = to_f(from_f<T>(p));
      }
    }
#pragma unroll
    for (int off = 1; off < TPQ; off <<= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l_run = l_run * scale + psum;
    m_run = m_new;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= scale;
    __syncthreads();  // Ps row complete
    for (int j = 0; j < nk; ++j) {
      const float p = Ps[ql][j];
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = fmaf(p, Vs[j][sub * DPT + i], acc[i]);
    }
  }
  if (qi < Tlen) {
    T* o = out + ((size_t)b * Tlen + qi) * D + hd * DK + sub * DPT;
#pragma unroll
    for (int i = 0; i < DPT; ++i) o[i] = from_f<T>(acc[i] / l_run);
  }
}

template <typename T, int DK>
void launch_attention(const T* qkv, const float* kmask, T* out, int B, int Tlen,
                      int D, int H, cudaStream_t st) {
  constexpr int TPQ = DK >= 4 ? 4 : DK;
  dim3 grid((Tlen + 63) / 64, H, B);
  attention_kernel<T, DK><<<grid, 64 * TPQ, 0, st>>>(qkv, kmask, out, Tlen, D);
}

template <typename T>
void gemm(const T* A, int lda, const T* W, const T* bias, int M, int N, int K,
          float alpha, int epi, T* out, int ldo, float* res, int ldr,
          cudaStream_t st) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_bias_kernel<T><<<grid, kGemmThreads, 0, st>>>(A, lda, W, bias, M, N, K, alpha,
                                                     epi, out, ldo, res, ldr);
}

template <typename Tin, typename Tw, typename Tout>
void ln_rows(const Tin* x, const Tw* a, const Tw* b, Tout* y, float* x32, int rows,
             int D, cudaStream_t st) {
  const int rows_per_block = kLnThreads / 32;
  ln_rows_kernel<Tin, Tw, Tout><<<(rows + rows_per_block - 1) / rows_per_block,
                                  kLnThreads, 0, st>>>(x, a, b, y, x32, rows, D);
}

template <typename T>
int run_stack(const T* x, const float* kmask, T* out, const void* const* lp,
              int n_layers, const T* fa, const T* fb, float* xres, T* xn, T* qkv,
              T* attn, T* mid, int B, int Tlen, int D, int H, int F,
              cudaStream_t st) {
  const int M = B * Tlen;
  const int dk = D / H;
  if (dk * H != D) return (int)cudaErrorInvalidValue;
  if (dk != 2 && dk != 4 && dk != 8 && dk != 16 && dk != 32)
    return (int)cudaErrorInvalidValue;
  const float inv_sqrt_dk = 1.0f / sqrtf((float)dk);
  if (n_layers == 0) {
    ln_rows<T, T, T>(x, fa, fb, out, nullptr, M, D, st);
    return (int)cudaGetLastError();
  }
  for (int l = 0; l < n_layers; ++l) {
    const T* p[16];
    for (int i = 0; i < 16; ++i) p[i] = static_cast<const T*>(lp[16 * l + i]);
    // p: ln1a ln1b wq bq wk bk wv bv wo bo ln2a ln2b w1 b1 w2 b2
    if (l == 0)
      ln_rows<T, T, T>(x, p[0], p[1], xn, xres, M, D, st);
    else
      ln_rows<float, T, T>(xres, p[0], p[1], xn, nullptr, M, D, st);
    gemm<T>(xn, D, p[2], p[3], M, D, D, inv_sqrt_dk, kStore, qkv, 3 * D, nullptr, 0, st);
    gemm<T>(xn, D, p[4], p[5], M, D, D, 1.f, kStore, qkv + D, 3 * D, nullptr, 0, st);
    gemm<T>(xn, D, p[6], p[7], M, D, D, 1.f, kStore, qkv + 2 * D, 3 * D, nullptr, 0, st);
    switch (dk) {
      case 2: launch_attention<T, 2>(qkv, kmask, attn, B, Tlen, D, H, st); break;
      case 4: launch_attention<T, 4>(qkv, kmask, attn, B, Tlen, D, H, st); break;
      case 8: launch_attention<T, 8>(qkv, kmask, attn, B, Tlen, D, H, st); break;
      case 16: launch_attention<T, 16>(qkv, kmask, attn, B, Tlen, D, H, st); break;
      default: launch_attention<T, 32>(qkv, kmask, attn, B, Tlen, D, H, st); break;
    }
    gemm<T>(attn, D, p[8], p[9], M, D, D, 1.f, kResidual, nullptr, 0, xres, D, st);
    ln_rows<float, T, T>(xres, p[10], p[11], xn, nullptr, M, D, st);
    gemm<T>(xn, D, p[12], p[13], M, F, D, 1.f, kStoreRelu, mid, F, nullptr, 0, st);
    gemm<T>(mid, F, p[14], p[15], M, D, F, 1.f, kResidual, nullptr, 0, xres, D, st);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  ln_rows<float, T, T>(xres, fa, fb, out, nullptr, M, D, st);
  return (int)cudaGetLastError();
}

}  // namespace enc
}  // namespace mmtx

// C entry.  All tensors contiguous; x/out [B, T, D]; kmask [B, T] fp32;
// layer_ptrs holds 16 device pointers per layer (see run_stack); scratch:
// xres fp32 [B*T, D], xn [B*T, D], qkv [B*T, 3D], attn [B*T, D], mid [B*T, F]
// in the storage dtype.  Returns cudaGetLastError() after the launches.
extern "C" int mmtx_encoder_stack(int dtype, const void* x, const void* kmask,
                                  void* out, const void* layer_ptrs, int n_layers,
                                  const void* fnorm_a, const void* fnorm_b,
                                  void* xres, void* xn, void* qkv, void* attn,
                                  void* mid, int B, int T, int D, int H, int F,
                                  void* stream) {
  using namespace mmtx;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* const* lp = static_cast<const void* const*>(layer_ptrs);
  const float* km = static_cast<const float*>(kmask);
  float* xr = static_cast<float*>(xres);
  if (dtype == kF32) {
    return enc::run_stack<float>(
        static_cast<const float*>(x), km, static_cast<float*>(out), lp, n_layers,
        static_cast<const float*>(fnorm_a), static_cast<const float*>(fnorm_b), xr,
        static_cast<float*>(xn), static_cast<float*>(qkv), static_cast<float*>(attn),
        static_cast<float*>(mid), B, T, D, H, F, st);
  }
  if (dtype == kBF16) {
    using bf = __nv_bfloat16;
    return enc::run_stack<bf>(
        static_cast<const bf*>(x), km, static_cast<bf*>(out), lp, n_layers,
        static_cast<const bf*>(fnorm_a), static_cast<const bf*>(fnorm_b), xr,
        static_cast<bf*>(xn), static_cast<bf*>(qkv), static_cast<bf*>(attn),
        static_cast<bf*>(mid), B, T, D, H, F, st);
  }
  return (int)cudaErrorInvalidValue;
}
