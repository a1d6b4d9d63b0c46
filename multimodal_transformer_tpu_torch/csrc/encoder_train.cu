// Kernels 3 and 4: the key-masked pre-norm encoder stack with in-kernel hash
// dropout (training forward), and one layer's backward.
//
// Replaces: multimodal_transformer_tpu/ops/pallas/encoder.py
//   kernel 3  _train_fwd_impl (body _train_kernel, _attention_tile);
//   kernel 4  _layer_bwd_call (body _bwd_kernel, _layer_bwd_core, _ln_bwd).
//
// Forward, per layer (no final norm: the caller applies it, so autograd owns
// its parameters): quirky LN (unbiased std, eps on the std) -> Q, K, V
// projections, q pre-scaled by 1/sqrt(d_k) before rounding -> h-head
// attention with the keys masked to -1e9 and dropout on the probabilities
// -> output projection, dropout, residual -> quirky LN -> FFN with ReLU and
// dropout on the hidden -> dropout, residual.  Each layer's input (the fp32
// residual stream) is written to `saved` for the backward.  Rounding points
// follow the TPU kernel: matmul inputs in the storage dtype, fp32
// accumulation, LN / softmax / residual in fp32.  Kernel A (csrc/encoder.cu)
// computes the same layers without dropout in its own kernels: running it
// through this file's generic strided GEMM and dropout-aware attention made
// it ~19% slower on the card.  So kernel 3 shares pieces, not kernels, and
// has two paths, chosen by the C entry (`mmtx_encoder_train_fwd_path`, the
// wrapper's kernel_path):
//   * bf16 at d_k in {16, 32}, D in {128, 256} and F = 128: kernel A's
//     wgmma row chain with the three row sites' dropout in its epilogues
//     and the residual rows stored to `saved` (csrc/encoder.cu,
//     chain_kernel<D, F, true>), around kernel 4's attention forward with
//     the site-0 dropout (csrc/encoder_bwd.cu): 2 N + 1 launches a stack;
//   * fp32, and bf16 at other widths: the FMA code below, ~10 launches a
//     layer.
//
// Dropout: every site draws the JAX package's fmix32 keep bit of the
// position in the unpadded JAX tensor, ((b*h + head)*T + tq)*T + tk for the
// probabilities and (b*T + t)*width + c for the three row sites, so the masks
// equal the JAX package's bit for bit.  On the "hash4" stream (t8 >= 0) a
// site whose last axis is a multiple of 4 draws common.cuh hash4_keep at its
// (row, column) instead: row (b*h + head)*T + tq, column tk, for the
// probabilities (multi-bit only when T % 4 == 0), row b*T + t for the
// others, as the JAX package's kernels (ops/pallas/encoder.py _row_keep,
// _attn_keep) do.
//
// Backward (one layer, kernel 4; the whole stack, kernel 5): recomputes the
// layer from its saved input (the probabilities are rebuilt tile by tile,
// so no [T, T] block is ever stored and every T works), regenerates the
// keep bits from the hash, and emits dx and the 16 parameter gradients.
// Two paths, chosen by the C entries (`mmtx_encoder_bwd_path`, the
// wrapper's kernel_path):
//   * bf16 at d_k in {16, 32}, D in {128, 256} and F = 128: every product
//     on wgmma, eight launches a layer, at the TPU kernel's rounding points
//     (csrc/encoder_bwd.cu);
//   * fp32, and bf16 at other widths: the code below, every product a
//     strided 64x64-tile FMA GEMM with a fused epilogue from gemm.cuh, the
//     attention backward in two FMA passes (one block per query tile for
//     D_i = sum_k P_ik dP_ik and dq, one per key tile for dk and dv), ~43
//     launches a layer.  It keeps ds in fp32 where the TPU kernel rounds it
//     to the storage dtype before the dq/dk products; dq, dk, dv are stored
//     in the storage dtype as there.  At MFT shapes (B=32, T=160, D=256,
//     h=8, F=128) a layer's ~10 GFLOP run on the fp32 FMA pipes (67 TFLOP/s
//     peak): compute-bound, far below the tensor cores.
// Weight gradients are split over fixed row chunks whose partials a second
// pass adds in order (no float atomics), so the gradients are bit-identical
// from run to run on both paths.
//
// Kernel 5 (mmtx_encoder_stack_bwd, replaces _stack_bwd_call) runs kernel 4's
// sequence for every layer, last first, in one host call: the workspace is
// carved once, dy is carried between layers in two fp32 [B, T, D] buffers,
// every gradient lands in its stacked [N, ...] output.  On the FMA path the
// layer boundary is fused: the last LayerNorm backward of layer l also
// writes layer l-1's dropout-masked FFN-output gradient, the first thing
// layer l-1 needs; the wgmma path draws that dropout from dy in its chain.
// The arithmetic is kernel 4's, in the same order, so kernel 5's outputs
// are bit-identical to N kernel-4 calls on both paths.

#include "encoder_bwd.cuh"
#include "encoder_train_fwd.cuh"
#include "gemm.cuh"

namespace mmtx {
namespace enct {

constexpr float kMaskedScore = -1e9f;
constexpr int kLnThreads = 256;  // one warp per row

// y = a * (x - mean) / (std_unbiased + eps) + b per row; optionally copies
// the row to x32 in fp32.
template <typename Tin, typename Tw, typename Tout>
__global__ void __launch_bounds__(kLnThreads)
ln_rows_kernel(const Tin* __restrict__ x, const Tw* __restrict__ a,
               const Tw* __restrict__ b, Tout* __restrict__ y,
               float* __restrict__ x32, int rows, int D) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
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

template <typename Tin, typename Tw, typename Tout>
void ln_rows(const Tin* x, const Tw* a, const Tw* b, Tout* y, float* x32, int rows,
             int D, cudaStream_t st) {
  const int per_block = kLnThreads / 32;
  ln_rows_kernel<Tin, Tw, Tout><<<(rows + per_block - 1) / per_block, kLnThreads, 0,
                                  st>>>(x, a, b, y, x32, rows, D);
}

// VJP of the quirky LayerNorm for one row per warp (the TPU kernel's _ln_bwd):
// dx = base + (dd - mean(dd)) with dd = g*a/denom + d * 2*dvar/(D-1), and
// dvar = 0 on rows with var == 0.  Also writes g * (x - mean) / denom, whose
// column sums are the gradient of a.
//
// With `drop` set (kernel 5's layer boundary) it also writes drop[i] =
// dropout'(dx[i]) at (row, column) with `site`: the dropout-masked
// FFN-output gradient of the layer below, from the value just computed.
template <typename Tw>
__global__ void __launch_bounds__(kLnThreads)
ln_bwd_kernel(const float* __restrict__ x, const Tw* __restrict__ a,
              const float* __restrict__ g, const float* __restrict__ base,
              float* __restrict__ dx, float* __restrict__ gdn, int rows, int D,
              float* __restrict__ drop, DropSite site) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t o = (size_t)row * D;
  float s = 0.f;
  for (int i = lane; i < D; i += 32) s += x[o + i];
  const float mean = warp_sum(s) / (float)D;
  float v = 0.f, sgad = 0.f;
  for (int i = lane; i < D; i += 32) {
    const float d = x[o + i] - mean;
    v += d * d;
    sgad += g[o + i] * to_f(a[i]) * d;
  }
  const float var = warp_sum(v) / (float)(D - 1);
  sgad = warp_sum(sgad);
  const float sd = sqrtf(var);
  const float denom = sd + 1e-6f;
  const float dden = -sgad / (denom * denom);
  const float dvar = var > 0.f ? dden / (2.f * sd) : 0.f;
  const float coef = 2.f * dvar / (float)(D - 1);
  float sdd = 0.f;
  for (int i = lane; i < D; i += 32) {
    const float d = x[o + i] - mean;
    sdd += g[o + i] * to_f(a[i]) / denom + d * coef;
  }
  const float mdd = warp_sum(sdd) / (float)D;
  for (int i = lane; i < D; i += 32) {
    const float d = x[o + i] - mean;
    const float dd = g[o + i] * to_f(a[i]) / denom + d * coef;
    const float dxv = base[o + i] + dd - mdd;
    dx[o + i] = dxv;
    gdn[o + i] = g[o + i] * (d / denom);
    if (drop != nullptr) drop[o + i] = site.apply_at(dxv, (uint32_t)row, (uint32_t)i, (uint32_t)D);
  }
}

template <typename Tw>
void ln_bwd(const float* x, const Tw* a, const float* g, const float* base, float* dx,
            float* gdn, int rows, int D, cudaStream_t st, float* drop = nullptr,
            DropSite site = DropSite{{0u, 0u}, 1.f}) {
  const int per_block = kLnThreads / 32;
  ln_bwd_kernel<Tw><<<(rows + per_block - 1) / per_block, kLnThreads, 0, st>>>(
      x, a, g, base, dx, gdn, rows, D, drop, site);
}

// The element-wise row kernels: one block a row of a [rows, width] site,
// its threads along the columns, so each value's (row, column) is known.
constexpr int kRowThreads = 128;

// out = dropout'(g) at each (row, column): the backward of a row site.
__global__ void __launch_bounds__(kRowThreads)
drop_grad_kernel(const float* __restrict__ g, DropSite s, int width, float* __restrict__ out) {
  const size_t o = (size_t)blockIdx.x * width;
  for (int c = threadIdx.x; c < width; c += kRowThreads)
    out[o + c] = s.apply_at(g[o + c], blockIdx.x, (uint32_t)c, (uint32_t)width);
}

// out = dropout(relu(pre)) in the storage dtype: the FFN hidden as the
// forward fed it to the second product.
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
relu_drop_kernel(const float* __restrict__ pre, DropSite s, int width, T* __restrict__ out) {
  const size_t o = (size_t)blockIdx.x * width;
  for (int c = threadIdx.x; c < width; c += kRowThreads)
    out[o + c] = from_f<T>(s.apply_at(fmaxf(pre[o + c], 0.f), blockIdx.x, (uint32_t)c,
                                      (uint32_t)width));
}

inline unsigned blocks_for(long long n) { return (unsigned)((n + 255) / 256); }

template <typename T>
__global__ void to_f32_kernel(const T* __restrict__ x, long long n, float* __restrict__ out) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) out[i] = to_f(x[i]);
}

// ---------------------------------------------------------------- epilogues

template <typename T> struct EpiScaleStore {  // out = T((acc + b) * alpha)
  const T* bias; float alpha; T* out; int ld;
  __device__ void operator()(int m, int n, int, float acc) const {
    out[(size_t)m * ld + n] = from_f<T>((acc + to_f(bias[n])) * alpha);
  }
};

template <typename T> struct EpiResidualDrop {  // res += dropout(acc + b)
  const T* bias; float* res; int ld; DropSite s;
  __device__ void operator()(int m, int n, int, float acc) const {
    const size_t i = (size_t)m * ld + n;
    res[i] += s.apply_at(acc + to_f(bias[n]), (uint32_t)m, (uint32_t)n, (uint32_t)ld);
  }
};

template <typename T> struct EpiReluDropStore {  // out = T(dropout(relu(acc + b)))
  const T* bias; T* out; int ld; DropSite s;
  __device__ void operator()(int m, int n, int, float acc) const {
    const size_t i = (size_t)m * ld + n;
    out[i] = from_f<T>(s.apply_at(fmaxf(acc + to_f(bias[n]), 0.f), (uint32_t)m, (uint32_t)n,
                                  (uint32_t)ld));
  }
};

template <typename T> struct EpiBiasStoreF32 {  // out = acc + b (fp32)
  const T* bias; float* out; int ld;
  __device__ void operator()(int m, int n, int, float acc) const {
    out[(size_t)m * ld + n] = acc + to_f(bias[n]);
  }
};

template <typename T> struct EpiStoreT {  // out = T(acc)
  T* out; int ld;
  __device__ void operator()(int m, int n, int, float acc) const {
    out[(size_t)m * ld + n] = from_f<T>(acc);
  }
};

struct EpiStoreF32 {  // out = acc, or out += acc
  float* out; int ld; bool add;
  __device__ void operator()(int m, int n, int, float acc) const {
    const size_t i = (size_t)m * ld + n;
    out[i] = add ? out[i] + acc : acc;
  }
};

struct EpiFfnHiddenGrad {  // the gradient of the FFN hidden before its ReLU
  const float* pre; float* out; int ld; DropSite s;
  __device__ void operator()(int m, int n, int, float acc) const {
    const size_t i = (size_t)m * ld + n;
    const float v = s.apply_at(acc, (uint32_t)m, (uint32_t)n, (uint32_t)ld);
    out[i] = pre[i] > 0.f ? v : 0.f;
  }
};

// y[M, N] = x[M, K] @ W^T + epilogue, W in torch layout [N, K].
template <typename T, typename Epi>
void linear(const T* x, int ldx, const T* W, int M, int N, int K, Epi epi,
            cudaStream_t st) {
  gemm_strided<T, T>(x, ldx, 1, W, 1, K, M, N, K, 1, epi, st);
}

// y[M, Nin] = g[M, Nout] @ W, W in torch layout [Nout, Nin].
template <typename TG, typename T, typename Epi>
void linear_grad_input(const TG* g, int ldg, const T* W, int M, int Nout, int Nin,
                       Epi epi, cudaStream_t st) {
  gemm_strided<TG, T>(g, ldg, 1, W, Nin, 1, M, Nin, Nout, 1, epi, st);
}

// ---------------------------------------------------------------- attention

// Forward attention with dropout on the probabilities.  One block per
// (64-query tile, head, video), TPQ threads per query row, online softmax over
// 64-key tiles (kernel A's layout).  The normalizer sums every probability;
// the value sum takes the kept ones divided by (1 - p), rounded to the
// storage dtype as the TPU kernel feeds them to p @ v.  Optionally writes the
// row's log-sum-exp for the backward.
template <typename T, int DK>
__global__ void attn_fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ kmask,
                                T* __restrict__ out, float* __restrict__ lse, int Tlen,
                                int D, int H, DropSite site) {
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
  for (int d = 0; d < DK; ++d) q[d] = qi < Tlen ? to_f(base[(size_t)qi * rs + hd * DK + d]) : 0.f;
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;

  for (int k0 = 0; k0 < Tlen; k0 += KT) {
    __syncthreads();
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
    const float m_new = fmaxf(m_run, tmax);
    const float scale = expf(m_run - m_new);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const int j = jj * TPQ + sub;
      if (j < nk) {
        const float p = expf(s[jj] - m_new);
        psum += p;
        const bool kept = site.keep_at(prob_row(b, H, hd, Tlen, qi), k0 + j, Tlen);
        Ps[ql][j] = kept ? to_f(from_f<T>(p / site.keep_p)) : 0.f;
      }
    }
#pragma unroll
    for (int off = 1; off < TPQ; off <<= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l_run = l_run * scale + psum;
    m_run = m_new;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= scale;
    __syncthreads();
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
    if (lse != nullptr && sub == 0) lse[((size_t)b * H + hd) * Tlen + qi] = m_run + logf(l_run);
  }
}

// Backward pass 1: one block per (64-query tile, head, video).  For each
// query row, D_i = sum_k P_ik dP_ik / sum_k P_ik over every key (first
// sweep), then dq_i = sum_k P_ik (dP_ik - D_i) / sqrt(d_k) k_k (second
// sweep), with P_ik = exp(s_ik - lse_i) rebuilt tile by tile and dP the
// dropout-masked do_i . v_k.  Writes dq (storage dtype) into dqkv and D_i
// for pass 2.  The rebuilt probabilities sum to 1 only up to the rounding of
// lse (~1 ulp of the largest score, ~1e-6 relative in fp32); dividing D_i by
// their sum keeps sum_k P_ik (dP_ik - D_i) = 0 to rounding, as the softmax
// gradient is, so the k-projection bias gradient (whose exact value is 0)
// stays at rounding level over a long stack.
template <typename T, int DK>
__global__ void attn_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ dO,
                                   const float* __restrict__ kmask,
                                   const float* __restrict__ lse, float* __restrict__ Dsum,
                                   T* __restrict__ dqkv, int Tlen, int D, int H,
                                   DropSite site, float inv_sqrt_dk) {
  constexpr int QT = 64, KT = 64;
  constexpr int TPQ = DK >= 4 ? 4 : DK;
  constexpr int NT = QT * TPQ;
  constexpr int KPT = KT / TPQ;
  constexpr int DPT = DK / TPQ;
  __shared__ float Ks[KT][DK + 1];
  __shared__ float Vs[KT][DK + 1];
  __shared__ float Ss[QT][KT + 1];

  const int b = blockIdx.z, hd = blockIdx.y, q0 = blockIdx.x * QT;
  const int tid = threadIdx.x, ql = tid / TPQ, sub = tid % TPQ;
  const int qi = q0 + ql;
  const bool qok = qi < Tlen;
  const size_t rs = 3 * (size_t)D;
  const T* base = qkv + (size_t)b * Tlen * rs;
  const float* km = kmask + (size_t)b * Tlen;

  float q[DK], dov[DK];
#pragma unroll
  for (int d = 0; d < DK; ++d) {
    q[d] = qok ? to_f(base[(size_t)qi * rs + hd * DK + d]) : 0.f;
    dov[d] = qok ? to_f(dO[((size_t)b * Tlen + qi) * D + hd * DK + d]) : 0.f;
  }
  const float lse_i = qok ? lse[((size_t)b * H + hd) * Tlen + qi] : 0.f;
  float Di = 0.f, Psum = 0.f;
  float dq[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) dq[i] = 0.f;

  for (int sweep = 0; sweep < 2; ++sweep) {
    for (int k0 = 0; k0 < Tlen; k0 += KT) {
      __syncthreads();
      for (int idx = tid; idx < KT * DK; idx += NT) {
        const int j = idx / DK, d = idx % DK, kj = k0 + j;
        const bool ok = kj < Tlen;
        Ks[j][d] = ok ? to_f(base[(size_t)kj * rs + D + hd * DK + d]) : 0.f;
        Vs[j][d] = ok ? to_f(base[(size_t)kj * rs + 2 * D + hd * DK + d]) : 0.f;
      }
      __syncthreads();
      const int nk = min(KT, Tlen - k0);
      float part = 0.f, ppart = 0.f;
#pragma unroll
      for (int jj = 0; jj < KPT; ++jj) {
        const int j = jj * TPQ + sub;
        if (j < nk) {
          float dot = 0.f, dpd = 0.f;
#pragma unroll
          for (int d = 0; d < DK; ++d) {
            dot = fmaf(q[d], Ks[j][d], dot);
            dpd = fmaf(dov[d], Vs[j][d], dpd);
          }
          if (km[k0 + j] == 0.f) dot = kMaskedScore;
          const float P = expf(dot - lse_i);
          const float dp = site.apply_at(dpd, prob_row(b, H, hd, Tlen, qi), k0 + j, Tlen);
          if (sweep == 0) {
            part += P * dp;
            ppart += P;
          } else {
            Ss[ql][j] = P * (dp - Di) * inv_sqrt_dk;
          }
        }
      }
      if (sweep == 0) {
        Di += part;
        Psum += ppart;
      } else {
        __syncthreads();
        for (int j = 0; j < nk; ++j) {
          const float ds = Ss[ql][j];
#pragma unroll
          for (int i = 0; i < DPT; ++i) dq[i] = fmaf(ds, Ks[j][sub * DPT + i], dq[i]);
        }
      }
    }
    if (sweep == 0) {
#pragma unroll
      for (int off = 1; off < TPQ; off <<= 1) {
        Di += __shfl_xor_sync(0xffffffffu, Di, off);
        Psum += __shfl_xor_sync(0xffffffffu, Psum, off);
      }
      Di = Psum > 0.f ? Di / Psum : 0.f;
    }
  }
  if (qok) {
    T* o = dqkv + ((size_t)b * Tlen + qi) * rs + hd * DK + sub * DPT;
#pragma unroll
    for (int i = 0; i < DPT; ++i) o[i] = from_f<T>(dq[i]);
    if (sub == 0) Dsum[((size_t)b * H + hd) * Tlen + qi] = Di;
  }
}

// Backward pass 2: one block per (64-key tile, head, video), TPQ threads per
// key, sweeping the queries in tiles of 32: dv_k = sum_q round(Pd_qk) do_q and
// dk_k = sum_q P_qk (dP_qk - D_q) q_q (q pre-scaled).  Writes dk and dv.
template <typename T, int DK>
__global__ void attn_bwd_dkv_kernel(const T* __restrict__ qkv, const T* __restrict__ dO,
                                    const float* __restrict__ kmask,
                                    const float* __restrict__ lse,
                                    const float* __restrict__ Dsum, T* __restrict__ dqkv,
                                    int Tlen, int D, int H, DropSite site) {
  constexpr int KT = 64, QT = 32;
  constexpr int TPK = DK >= 4 ? 4 : DK;
  constexpr int NT = KT * TPK;
  constexpr int QPT = QT / TPK;
  constexpr int DPT = DK / TPK;
  __shared__ float Qs[QT][DK + 1];
  __shared__ float Os[QT][DK + 1];
  __shared__ float Ls[QT], Dq[QT];
  __shared__ float Ps[KT][QT + 1];
  __shared__ float Ss[KT][QT + 1];

  const int b = blockIdx.z, hd = blockIdx.y, k0 = blockIdx.x * KT;
  const int tid = threadIdx.x, kl = tid / TPK, sub = tid % TPK;
  const int kj = k0 + kl;
  const bool kok = kj < Tlen;
  const size_t rs = 3 * (size_t)D;
  const T* base = qkv + (size_t)b * Tlen * rs;
  const bool masked = kok ? kmask[(size_t)b * Tlen + kj] == 0.f : true;

  float kv[DK], vv[DK];
#pragma unroll
  for (int d = 0; d < DK; ++d) {
    kv[d] = kok ? to_f(base[(size_t)kj * rs + D + hd * DK + d]) : 0.f;
    vv[d] = kok ? to_f(base[(size_t)kj * rs + 2 * D + hd * DK + d]) : 0.f;
  }
  float dk[DPT], dv[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) { dk[i] = 0.f; dv[i] = 0.f; }

  for (int q0 = 0; q0 < Tlen; q0 += QT) {
    __syncthreads();
    for (int idx = tid; idx < QT * DK; idx += NT) {
      const int i = idx / DK, d = idx % DK, qi = q0 + i;
      const bool ok = qi < Tlen;
      Qs[i][d] = ok ? to_f(base[(size_t)qi * rs + hd * DK + d]) : 0.f;
      Os[i][d] = ok ? to_f(dO[((size_t)b * Tlen + qi) * D + hd * DK + d]) : 0.f;
    }
    for (int i = tid; i < QT; i += NT) {
      const int qi = q0 + i;
      Ls[i] = qi < Tlen ? lse[((size_t)b * H + hd) * Tlen + qi] : 0.f;
      Dq[i] = qi < Tlen ? Dsum[((size_t)b * H + hd) * Tlen + qi] : 0.f;
    }
    __syncthreads();
    const int nq = min(QT, Tlen - q0);
#pragma unroll
    for (int ii = 0; ii < QPT; ++ii) {
      const int i = ii * TPK + sub;
      if (i < nq && kok) {
        float dot = 0.f, dpd = 0.f;
#pragma unroll
        for (int d = 0; d < DK; ++d) {
          dot = fmaf(Qs[i][d], kv[d], dot);
          dpd = fmaf(Os[i][d], vv[d], dpd);
        }
        if (masked) dot = kMaskedScore;
        const float P = expf(dot - Ls[i]);
        const bool kept = site.keep_at(prob_row(b, H, hd, Tlen, q0 + i), kj, Tlen);
        const float dp = kept ? dpd / site.keep_p : 0.f;
        Ps[kl][i] = kept ? to_f(from_f<T>(P / site.keep_p)) : 0.f;
        Ss[kl][i] = P * (dp - Dq[i]);
      }
    }
    __syncthreads();
    if (kok) {
      for (int i = 0; i < nq; ++i) {
        const float pd = Ps[kl][i], ds = Ss[kl][i];
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
          dv[c] = fmaf(pd, Os[i][sub * DPT + c], dv[c]);
          dk[c] = fmaf(ds, Qs[i][sub * DPT + c], dk[c]);
        }
      }
    }
  }
  if (kok) {
    T* o = dqkv + ((size_t)b * Tlen + kj) * rs + hd * DK + sub * DPT;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      o[D + c] = from_f<T>(dk[c]);
      o[2 * D + c] = from_f<T>(dv[c]);
    }
  }
}

template <typename T, int DK>
void attention_fwd(const T* qkv, const float* kmask, T* out, float* lse, int B, int Tlen,
                   int D, int H, DropSite site, cudaStream_t st) {
  constexpr int TPQ = DK >= 4 ? 4 : DK;
  dim3 grid((Tlen + 63) / 64, H, B);
  attn_fwd_kernel<T, DK><<<grid, 64 * TPQ, 0, st>>>(qkv, kmask, out, lse, Tlen, D, H, site);
}

template <typename T, int DK>
void attention_bwd(const T* qkv, const T* dO, const float* kmask, const float* lse,
                   float* Dsum, T* dqkv, int B, int Tlen, int D, int H, DropSite site,
                   float inv_sqrt_dk, cudaStream_t st) {
  constexpr int TPQ = DK >= 4 ? 4 : DK;
  dim3 grid((Tlen + 63) / 64, H, B);
  attn_bwd_dq_kernel<T, DK><<<grid, 64 * TPQ, 0, st>>>(qkv, dO, kmask, lse, Dsum, dqkv,
                                                       Tlen, D, H, site, inv_sqrt_dk);
  attn_bwd_dkv_kernel<T, DK><<<grid, 64 * TPQ, 0, st>>>(qkv, dO, kmask, lse, Dsum, dqkv,
                                                        Tlen, D, H, site);
}

template <typename T>
bool attention_fwd_any(int dk, const T* qkv, const float* kmask, T* out, float* lse, int B,
                       int Tlen, int D, int H, DropSite site, cudaStream_t st) {
  switch (dk) {
    case 2: attention_fwd<T, 2>(qkv, kmask, out, lse, B, Tlen, D, H, site, st); return true;
    case 4: attention_fwd<T, 4>(qkv, kmask, out, lse, B, Tlen, D, H, site, st); return true;
    case 8: attention_fwd<T, 8>(qkv, kmask, out, lse, B, Tlen, D, H, site, st); return true;
    case 16: attention_fwd<T, 16>(qkv, kmask, out, lse, B, Tlen, D, H, site, st); return true;
    case 32: attention_fwd<T, 32>(qkv, kmask, out, lse, B, Tlen, D, H, site, st); return true;
    default: return false;
  }
}

template <typename T>
bool attention_bwd_any(int dk, const T* qkv, const T* dO, const float* kmask,
                       const float* lse, float* Dsum, T* dqkv, int B, int Tlen, int D,
                       int H, DropSite site, float inv, cudaStream_t st) {
  switch (dk) {
    case 2: attention_bwd<T, 2>(qkv, dO, kmask, lse, Dsum, dqkv, B, Tlen, D, H, site, inv, st); return true;
    case 4: attention_bwd<T, 4>(qkv, dO, kmask, lse, Dsum, dqkv, B, Tlen, D, H, site, inv, st); return true;
    case 8: attention_bwd<T, 8>(qkv, dO, kmask, lse, Dsum, dqkv, B, Tlen, D, H, site, inv, st); return true;
    case 16: attention_bwd<T, 16>(qkv, dO, kmask, lse, Dsum, dqkv, B, Tlen, D, H, site, inv, st); return true;
    case 32: attention_bwd<T, 32>(qkv, dO, kmask, lse, Dsum, dqkv, B, Tlen, D, H, site, inv, st); return true;
    default: return false;
  }
}

// ------------------------------------------------------------ layer pieces

// Parameter order of one layer (16 pointers), as the wrapper passes them:
// ln1a ln1b wq bq wk bk wv bv wo bo ln2a ln2b w1 b1 w2 b2, torch layouts.
enum P : int { LN1A, LN1B, WQ, BQ, WK, BK, WV, BV, WO, BO, LN2A, LN2B, W1, B1, W2, B2 };

template <typename T>
struct Fwd {
  T* xn; T* qkv; T* attn; T* mid;
  static Fwd carve(Carver& c, int M, int D, int F) {
    Fwd f;
    f.xn = c.take<T>((size_t)M * D);
    f.qkv = c.take<T>((size_t)M * 3 * D);
    f.attn = c.take<T>((size_t)M * D);
    f.mid = c.take<T>((size_t)M * F);
    return f;
  }
};

template <typename T>
struct Bwd {
  T *xn1, *qkv, *o, *xn2, *midd, *dO, *dqkv;
  float *x1, *midp, *dff, *dmidp, *dxn, *dx1, *gdn, *dattn, *lse, *Dsum, *part;
  static Bwd carve(Carver& c, int B, int Tlen, int D, int H, int F) {
    const size_t M = (size_t)B * Tlen;
    Bwd w;
    w.xn1 = c.take<T>(M * D); w.qkv = c.take<T>(M * 3 * D); w.o = c.take<T>(M * D);
    w.xn2 = c.take<T>(M * D); w.midd = c.take<T>(M * F); w.dO = c.take<T>(M * D);
    w.dqkv = c.take<T>(M * 3 * D);
    w.x1 = c.take<float>(M * D); w.midp = c.take<float>(M * F);
    w.dff = c.take<float>(M * D); w.dmidp = c.take<float>(M * F);
    w.dxn = c.take<float>(M * D); w.dx1 = c.take<float>(M * D);
    w.gdn = c.take<float>(M * D); w.dattn = c.take<float>(M * D);
    w.lse = c.take<float>((size_t)B * H * Tlen); w.Dsum = c.take<float>((size_t)B * H * Tlen);
    const size_t wmax = (size_t)D * (D > F ? D : F);
    w.part = c.take<float>((size_t)grad_splits((int)M) * wmax);
    return w;
  }
};

// Kernel 5's workspace: kernel 4's, once, and the two fp32 [B, T, D] buffers
// that carry dy from layer to layer.
template <typename T>
struct StackBwd {
  Bwd<T> w;
  float* carry[2];
  static StackBwd carve(Carver& c, int B, int Tlen, int D, int H, int F) {
    StackBwd s;
    s.w = Bwd<T>::carve(c, B, Tlen, D, H, F);
    for (int i = 0; i < 2; ++i) s.carry[i] = c.take<float>((size_t)B * Tlen * D);
    return s;
  }
};

// Site k of a layer's 4 (0 the probabilities, of last axis T; 1, 2, 3 the
// row sites) at last axis `width`; t8 the stream (hash4_w4).
inline DropSite site_of(const uint32_t* seeds, int k, uint32_t thr, float kp, int t8,
                        int width) {
  return DropSite{DropBits::of(seeds[k], thr, t8, width), kp};
}

// The layer's forward up to the residual stream after attention: xn1, qkv,
// the attention output (and lse when asked), and res += dropout(out-proj).
template <typename T>
bool attention_sublayer(const T* const* p, const float* x_in, float* res, const float* kmask,
                        T* xn, T* qkv, T* attn, float* lse, const uint32_t* seeds,
                        uint32_t thr, float kp, int t8, int B, int Tlen, int D, int H,
                        cudaStream_t st) {
  const int M = B * Tlen, dk = D / H;
  const float inv_sqrt_dk = 1.0f / sqrtf((float)dk);
  ln_rows<float, T, T>(x_in, p[LN1A], p[LN1B], xn, nullptr, M, D, st);
  linear<T>(xn, D, p[WQ], M, D, D, EpiScaleStore<T>{p[BQ], inv_sqrt_dk, qkv, 3 * D}, st);
  linear<T>(xn, D, p[WK], M, D, D, EpiScaleStore<T>{p[BK], 1.f, qkv + D, 3 * D}, st);
  linear<T>(xn, D, p[WV], M, D, D, EpiScaleStore<T>{p[BV], 1.f, qkv + 2 * D, 3 * D}, st);
  if (!attention_fwd_any<T>(dk, qkv, kmask, attn, lse, B, Tlen, D, H,
                            site_of(seeds, 0, thr, kp, t8, Tlen), st))
    return false;
  linear<T>(attn, D, p[WO], M, D, D,
            EpiResidualDrop<T>{p[BO], res, D, site_of(seeds, 1, thr, kp, t8, D)}, st);
  return true;
}

template <typename T>
int train_fwd(const T* x, const float* kmask, float* out, float* saved,
              const void* const* lp, int n_layers, const uint32_t* seeds, uint32_t thr,
              float kp, int t8, void* ws, int B, int Tlen, int D, int H, int F,
              cudaStream_t st) {
  const int M = B * Tlen;
  Carver c{static_cast<char*>(ws)};
  Fwd<T> w = Fwd<T>::carve(c, M, D, F);
  // out doubles as the fp32 residual stream
  to_f32_kernel<T><<<blocks_for((long long)M * D), 256, 0, st>>>(x, (long long)M * D, out);
  for (int l = 0; l < n_layers; ++l) {
    const T* p[16];
    for (int i = 0; i < 16; ++i) p[i] = static_cast<const T*>(lp[16 * l + i]);
    const uint32_t* sd = seeds + 4 * l;
    cudaMemcpyAsync(saved + (size_t)l * M * D, out, (size_t)M * D * sizeof(float),
                    cudaMemcpyDeviceToDevice, st);
    if (!attention_sublayer<T>(p, out, out, kmask, w.xn, w.qkv, w.attn, nullptr, sd, thr,
                               kp, t8, B, Tlen, D, H, st))
      return (int)cudaErrorInvalidValue;
    ln_rows<float, T, T>(out, p[LN2A], p[LN2B], w.xn, nullptr, M, D, st);
    linear<T>(w.xn, D, p[W1], M, F, D,
              EpiReluDropStore<T>{p[B1], w.mid, F, site_of(sd, 2, thr, kp, t8, F)}, st);
    linear<T>(w.mid, F, p[W2], M, D, F,
              EpiResidualDrop<T>{p[B2], out, D, site_of(sd, 3, thr, kp, t8, D)}, st);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// One layer's backward in workspace w: dx and the 16 gradients g of the layer
// with parameters p, saved input x and output gradient dy.  dff_ready: w.dff
// already holds dropout'(dy) at site 3 (kernel 5 wrote it at the boundary
// above).  below: the 4 seeds of the layer under this one, whose site-3
// dropout gradient of dx the last LayerNorm backward writes into w.dff
// (nullptr: none).
template <typename T>
int layer_bwd_core(const float* x, const float* dy, const float* kmask, const T* const* p,
                   float* const* g, const uint32_t* seeds, const uint32_t* below,
                   bool dff_ready, uint32_t thr, float kp, int t8, float* dx,
                   const Bwd<T>& w, int B, int Tlen, int D, int H, int F, cudaStream_t st) {
  const int M = B * Tlen, dk = D / H;
  const float inv_sqrt_dk = 1.0f / sqrtf((float)dk);
  const long long MD = (long long)M * D;

  // ---- recompute the layer from its saved input
  cudaMemcpyAsync(w.x1, x, (size_t)MD * sizeof(float), cudaMemcpyDeviceToDevice, st);
  if (!attention_sublayer<T>(p, x, w.x1, kmask, w.xn1, w.qkv, w.o, w.lse, seeds, thr, kp, t8,
                             B, Tlen, D, H, st))
    return (int)cudaErrorInvalidValue;
  ln_rows<float, T, T>(w.x1, p[LN2A], p[LN2B], w.xn2, nullptr, M, D, st);
  linear<T>(w.xn2, D, p[W1], M, F, D, EpiBiasStoreF32<T>{p[B1], w.midp, F}, st);

  // ---- feed-forward sublayer
  if (!dff_ready)
    drop_grad_kernel<<<M, kRowThreads, 0, st>>>(dy, site_of(seeds, 3, thr, kp, t8, D), D, w.dff);
  relu_drop_kernel<T><<<M, kRowThreads, 0, st>>>(w.midp, site_of(seeds, 2, thr, kp, t8, F), F,
                                                 w.midd);
  weight_grad<float, T>(w.dff, D, w.midd, F, M, D, F, g[W2], w.part, st);
  colsum<float>(w.dff, D, M, D, g[B2], st);
  linear_grad_input<float, T>(w.dff, D, p[W2], M, D, F,
                              EpiFfnHiddenGrad{w.midp, w.dmidp, F,
                                               site_of(seeds, 2, thr, kp, t8, F)},
                              st);
  weight_grad<float, T>(w.dmidp, F, w.xn2, D, M, F, D, g[W1], w.part, st);
  colsum<float>(w.dmidp, F, M, F, g[B1], st);
  linear_grad_input<float, T>(w.dmidp, F, p[W1], M, F, D, EpiStoreF32{w.dxn, D, false}, st);
  ln_bwd<T>(w.x1, p[LN2A], w.dxn, dy, w.dx1, w.gdn, M, D, st);
  colsum<float>(w.gdn, D, M, D, g[LN2A], st);
  colsum<float>(w.dxn, D, M, D, g[LN2B], st);

  // ---- attention sublayer
  drop_grad_kernel<<<M, kRowThreads, 0, st>>>(w.dx1, site_of(seeds, 1, thr, kp, t8, D), D,
                                              w.dattn);
  weight_grad<float, T>(w.dattn, D, w.o, D, M, D, D, g[WO], w.part, st);
  colsum<float>(w.dattn, D, M, D, g[BO], st);
  linear_grad_input<float, T>(w.dattn, D, p[WO], M, D, D, EpiStoreT<T>{w.dO, D}, st);
  if (!attention_bwd_any<T>(dk, w.qkv, w.dO, kmask, w.lse, w.Dsum, w.dqkv, B, Tlen, D, H,
                            site_of(seeds, 0, thr, kp, t8, Tlen), inv_sqrt_dk, st))
    return (int)cudaErrorInvalidValue;
  const int wi[3] = {WQ, WK, WV}, bi[3] = {BQ, BK, BV};
  for (int j = 0; j < 3; ++j) {
    const T* dpart = w.dqkv + j * D;
    weight_grad<T, T>(dpart, 3 * D, w.xn1, D, M, D, D, g[wi[j]], w.part, st);
    colsum<T>(dpart, 3 * D, M, D, g[bi[j]], st);
    linear_grad_input<T, T>(dpart, 3 * D, p[wi[j]], M, D, D,
                            EpiStoreF32{w.dxn, D, j > 0}, st);
  }
  if (below != nullptr)
    ln_bwd<T>(x, p[LN1A], w.dxn, w.dx1, dx, w.gdn, M, D, st, w.dff,
              site_of(below, 3, thr, kp, t8, D));
  else
    ln_bwd<T>(x, p[LN1A], w.dxn, w.dx1, dx, w.gdn, M, D, st);
  colsum<float>(w.gdn, D, M, D, g[LN1A], st);
  colsum<float>(w.dxn, D, M, D, g[LN1B], st);
  return (int)cudaGetLastError();
}

template <typename T>
int layer_bwd(const float* x, const float* dy, const float* kmask, const void* const* lp,
              const uint32_t* seeds, uint32_t thr, float kp, int t8, float* dx,
              void* const* gp, void* ws, int B, int Tlen, int D, int H, int F,
              cudaStream_t st) {
  Carver c{static_cast<char*>(ws)};
  const Bwd<T> w = Bwd<T>::carve(c, B, Tlen, D, H, F);
  const T* p[16];
  float* g[16];
  for (int i = 0; i < 16; ++i) {
    p[i] = static_cast<const T*>(lp[i]);
    g[i] = static_cast<float*>(gp[i]);
  }
  return layer_bwd_core<T>(x, dy, kmask, p, g, seeds, nullptr, false, thr, kp, t8, dx, w, B,
                           Tlen, D, H, F, st);
}

// Elements of each of a layer's 16 parameters, in P order.
inline void param_sizes(int D, int F, size_t* n) {
  const size_t d = D, f = F;
  const size_t sizes[16] = {d, d, d * d, d, d * d, d, d * d, d, d * d, d, d, d, f * d, f,
                            d * f, d};
  for (int i = 0; i < 16; ++i) n[i] = sizes[i];
}

// Kernel 5: the stack's backward, last layer first.  saved [N, B, T, D]: each
// layer's input; dy: the gradient of the last layer's output; gp: the 16
// stacked fp32 [N, ...] gradient outputs.
template <typename T>
int stack_bwd(const float* saved, const float* dy, const float* kmask, const void* const* lp,
              int n_layers, const uint32_t* seeds, uint32_t thr, float kp, int t8, float* dx,
              void* const* gp, void* ws, int B, int Tlen, int D, int H, int F,
              cudaStream_t st) {
  const long long MD = (long long)B * Tlen * D;
  Carver c{static_cast<char*>(ws)};
  const StackBwd<T> sw = StackBwd<T>::carve(c, B, Tlen, D, H, F);
  size_t n[16];
  param_sizes(D, F, n);
  const int top = n_layers - 1;
  drop_grad_kernel<<<B * Tlen, kRowThreads, 0, st>>>(
      dy, site_of(seeds + 4 * top, 3, thr, kp, t8, D), D, sw.w.dff);
  const float* g_out = dy;
  for (int l = top; l >= 0; --l) {
    const T* p[16];
    float* g[16];
    for (int i = 0; i < 16; ++i) {
      p[i] = static_cast<const T*>(lp[16 * l + i]);
      g[i] = static_cast<float*>(gp[i]) + (size_t)l * n[i];
    }
    float* d_in = l == 0 ? dx : sw.carry[l & 1];
    const int rc = layer_bwd_core<T>(saved + (size_t)l * MD, g_out, kmask, p, g, seeds + 4 * l,
                                     l > 0 ? seeds + 4 * (l - 1) : nullptr, true, thr, kp, t8,
                                     d_in, sw.w, B, Tlen, D, H, F, st);
    if (rc != (int)cudaSuccess) return rc;
    g_out = d_in;
  }
  return (int)cudaGetLastError();
}

inline bool shape_ok(int B, int Tlen, int D, int H, int F) {
  if (B < 1 || Tlen < 1 || D < 2 || H < 1 || F < 1 || D % H) return false;
  const int dk = D / H;
  return dk == 2 || dk == 4 || dk == 8 || dk == 16 || dk == 32;
}

}  // namespace enct
}  // namespace mmtx

// Workspace bytes of kernel 3 (backward = 0), kernel 4 (backward = 1) or
// kernel 5 (backward = 2).
extern "C" long long mmtx_encoder_train_workspace(int dtype, int B, int T, int D, int H,
                                                  int F, int backward) {
  using namespace mmtx;
  Carver c{nullptr};
  const int M = B * T;
  if (enc_bwd::takes(dtype, D, H, F))
    return backward ? enc_bwd::workspace_bytes(B, T, D, H, F, backward == 2)
                    : enc_wgmma::train_workspace_bytes(B, T, D);
  if (dtype == kBF16) {
    if (backward == 2) enct::StackBwd<__nv_bfloat16>::carve(c, B, T, D, H, F);
    else if (backward) enct::Bwd<__nv_bfloat16>::carve(c, B, T, D, H, F);
    else enct::Fwd<__nv_bfloat16>::carve(c, M, D, F);
  } else {
    if (backward == 2) enct::StackBwd<float>::carve(c, B, T, D, H, F);
    else if (backward) enct::Bwd<float>::carve(c, B, T, D, H, F);
    else enct::Fwd<float>::carve(c, M, D, F);
  }
  return (long long)c.used + 256;
}

// Kernel 3.  x [B, T, D] in the storage dtype; kmask [B, T] fp32; out fp32
// [B, T, D] (the last layer's output, no final norm); saved fp32 [N, B, T, D]
// (each layer's input); layer_ptrs: 16 device pointers per layer; seeds:
// host array of 4 uint32 per layer; threshold / keep_p: the dropout rate;
// t8: the stream, -1 the per-element "hash" bits, else the "hash4" bits at
// that 8-bit threshold (hash4_keep) on every site of last axis % 4 == 0.
extern "C" int mmtx_encoder_train_fwd(int dtype, const void* x, const void* kmask,
                                      void* out, void* saved, const void* layer_ptrs,
                                      int n_layers, const void* seeds, unsigned threshold,
                                      float keep_p, int t8, void* workspace, int B, int T,
                                      int D, int H, int F, void* stream) {
  using namespace mmtx;
  if (!enct::shape_ok(B, T, D, H, F) || n_layers < 1 || t8 > 255)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* const* lp = static_cast<const void* const*>(layer_ptrs);
  const uint32_t* sd = static_cast<const uint32_t*>(seeds);
  const float* km = static_cast<const float*>(kmask);
  float* o = static_cast<float*>(out);
  float* sv = static_cast<float*>(saved);
  if (enc_bwd::takes(dtype, D, H, F))
    return enc_wgmma::train_fwd(static_cast<const __nv_bfloat16*>(x), km, o, sv, lp, n_layers,
                                sd, threshold, keep_p, t8, workspace, B, T, D, H, F, st);
  if (dtype == kF32)
    return enct::train_fwd<float>(static_cast<const float*>(x), km, o, sv, lp, n_layers, sd,
                                  threshold, keep_p, t8, workspace, B, T, D, H, F, st);
  if (dtype == kBF16)
    return enct::train_fwd<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x), km, o, sv, lp,
                                          n_layers, sd, threshold, keep_p, t8, workspace, B,
                                          T, D, H, F, st);
  return (int)cudaErrorInvalidValue;
}

// The path kernels 4 and 5 take for (dtype, D, h, F), as the wrapper's
// kernel_path chooses it: 1 (wgmma, csrc/encoder_bwd.cu) for bf16 at d_k
// in {16, 32}, D in {128, 256} and F = 128, else 0 (the FMA code here).
extern "C" int mmtx_encoder_bwd_path(int dtype, int D, int H, int F) {
  return mmtx::enc_bwd::takes(dtype, D, H, F) ? 1 : 0;
}

// The path kernel 3 takes, likewise: 1 (wgmma: kernel A's row chain with
// the dropout, csrc/encoder.cu, around kernel 4's attention forward) for
// the shapes of kernels 4 and 5's wgmma path, else 0 (the FMA code here).
extern "C" int mmtx_encoder_train_fwd_path(int dtype, int D, int H, int F) {
  return mmtx::enc_bwd::takes(dtype, D, H, F) ? 1 : 0;
}

// Kernel 4.  x_l, dy fp32 [B, T, D]; layer_ptrs: the layer's 16 parameters
// in the storage dtype; seeds: host array of the layer's 4 uint32 seeds;
// t8: the stream (as kernel 3's); dx fp32 [B, T, D]; grad_ptrs: 16 fp32
// device buffers shaped like the parameters.  Every output is written whole
// (nothing accumulates).
extern "C" int mmtx_encoder_layer_bwd(int dtype, const void* x, const void* dy,
                                      const void* kmask, const void* layer_ptrs,
                                      const void* seeds, unsigned threshold, float keep_p,
                                      int t8, void* dx, const void* grad_ptrs,
                                      void* workspace, int B, int T, int D, int H, int F,
                                      void* stream) {
  using namespace mmtx;
  if (!enct::shape_ok(B, T, D, H, F) || t8 > 255) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* const* lp = static_cast<const void* const*>(layer_ptrs);
  void* const* gp = static_cast<void* const*>(const_cast<void*>(grad_ptrs));
  const uint32_t* sd = static_cast<const uint32_t*>(seeds);
  const float* xx = static_cast<const float*>(x);
  const float* g = static_cast<const float*>(dy);
  const float* km = static_cast<const float*>(kmask);
  float* d = static_cast<float*>(dx);
  if (enc_bwd::takes(dtype, D, H, F))
    return enc_bwd::layer_bwd(xx, g, km, lp, sd, threshold, keep_p, t8, d, gp, workspace, B, T,
                              D, H, F, st);
  if (dtype == kF32)
    return enct::layer_bwd<float>(xx, g, km, lp, sd, threshold, keep_p, t8, d, gp, workspace,
                                  B, T, D, H, F, st);
  if (dtype == kBF16)
    return enct::layer_bwd<__nv_bfloat16>(xx, g, km, lp, sd, threshold, keep_p, t8, d, gp,
                                          workspace, B, T, D, H, F, st);
  return (int)cudaErrorInvalidValue;
}

// Kernel 5.  saved fp32 [N, B, T, D] (kernel 3's, each layer's input); dy fp32
// [B, T, D] (the gradient of the last layer's output); layer_ptrs: 16 device
// pointers per layer in the storage dtype; seeds: host array of 4 uint32 per
// layer; t8: the stream (as kernel 3's); dx fp32 [B, T, D]; grad_ptrs: 16
// fp32 device buffers, each the parameter's gradient stacked over the layers
// [N, ...].  Every output is written whole.
extern "C" int mmtx_encoder_stack_bwd(int dtype, const void* saved, const void* dy,
                                      const void* kmask, const void* layer_ptrs,
                                      int n_layers, const void* seeds, unsigned threshold,
                                      float keep_p, int t8, void* dx, const void* grad_ptrs,
                                      void* workspace, int B, int T, int D, int H, int F,
                                      void* stream) {
  using namespace mmtx;
  if (!enct::shape_ok(B, T, D, H, F) || n_layers < 1 || t8 > 255)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* const* lp = static_cast<const void* const*>(layer_ptrs);
  void* const* gp = static_cast<void* const*>(const_cast<void*>(grad_ptrs));
  const uint32_t* sd = static_cast<const uint32_t*>(seeds);
  const float* sv = static_cast<const float*>(saved);
  const float* g = static_cast<const float*>(dy);
  const float* km = static_cast<const float*>(kmask);
  float* d = static_cast<float*>(dx);
  if (enc_bwd::takes(dtype, D, H, F))
    return enc_bwd::stack_bwd(sv, g, km, lp, n_layers, sd, threshold, keep_p, t8, d, gp,
                              workspace, B, T, D, H, F, st);
  if (dtype == kF32)
    return enct::stack_bwd<float>(sv, g, km, lp, n_layers, sd, threshold, keep_p, t8, d, gp,
                                  workspace, B, T, D, H, F, st);
  if (dtype == kBF16)
    return enct::stack_bwd<__nv_bfloat16>(sv, g, km, lp, n_layers, sd, threshold, keep_p, t8,
                                          d, gp, workspace, B, T, D, H, F, st);
  return (int)cudaErrorInvalidValue;
}
