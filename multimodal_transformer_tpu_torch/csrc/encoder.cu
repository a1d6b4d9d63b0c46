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
// in fp32; q (pre-scaled by 1/sqrt(d_k)), k, v, the attention output, the
// FFN hidden and p in p @ v stored in the storage dtype.
//
// What bounds it on the H100: at MFT shapes (B=32, T=160, D=256, h=8, F=128,
// 6 layers) one stack is ~20 GFLOP of projections and ~5 GFLOP of attention
// (0.025 ms on the bf16 tensor cores) against ~0.2 GB of activation traffic
// between launches (~0.06 ms at 3.35 TB/s).  What holds it above both is
// latency: a block's loads, row statistics, products and epilogues run one
// after another in one warpgroup, and every launch waits for the one
// before.  On an H100 (bf16 path, B=32, T=160) a middle row chain spends
// the largest share of its time in epilogues and stores, then in its
// products, then in its two LNs, while each of the 80 chains reads the
// layer's 640 KB of weights from L2.
//
// Two paths, chosen by the wrapper (`kernel_path`) and checked here:
//   * fp32, and bf16 at d_k < 16 or at widths the wgmma tiling does not
//     take: every product on the FMA pipes (64x64 smem-tiled GEMMs with
//     fused bias, ReLU, scale and fp32-residual epilogues; LN its own
//     launch; attention one block per (video, head, 64-query tile) walking
//     64-key tiles with an online softmax): 9 launches a layer.
//   * bf16 at d_k in {16, 32}, D in {128, 256} and F = 128 (namespace
//     enc_wgmma): 2 N + 1 launches a stack of N layers, every product on
//     wgmma (m64n128k16 chains, fp32 accumulation), one warpgroup a block.
//     - The row chain: everything from a layer's attention output to the
//       next layer's q, k and v is row-local, so one block of 64 rows runs
//       the out projection + residual, LN2, FFN1 + ReLU, FFN2 + residual
//       and the next layer's LN1 + QKV (one product of N = 3D over the
//       three weight pointers); on the last layer the final norm instead,
//       into the output; layer 0's chain is its LN1 + QKV alone.  Its
//       weights stream through a ring of two 64 KB slots by TMA (pieces of
//       128 rows x K, one thread issuing a piece's boxes; torch's [N, K]
//       layout is wgmma's K-major B, landing in the 128-byte swizzle; a
//       weight's map is encoded once and cached on the host): 640 KB a
//       layer at D = 256, resident in L2, the next piece loading while one
//       is multiplied.
//       The residual rows stay in shared memory in fp32 for the whole
//       chain (one coalesced load from xres, one store back).  A thread's
//       accumulators are, read by 16-column k steps, its A fragments: LN
//       reads the residual where the thread's own fragment lies (a row lies
//       with the 4 threads of a quad, two shuffles for its statistics) and
//       rounds the normalised values to bf16 straight into the fragments,
//       and FFN1's ReLU output is FFN2's A without leaving registers.  The
//       out projection reads the attention output as a swizzled tile (both
//       operands in shared memory).  Outputs leave through a staging tile as
//       16-byte rows: a warp's fragment touches 8 rows a store.
//     - Attention (below): one block per (64-query tile, head, video).
//     B*T = 5,120 rows make 80 row chains (one an SM: 227 KB of shared
//     memory) and 768 attention blocks.  No atomics: the same inputs give
//     the same bits.

#include "rows.cuh"

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

// ---------------------------------------------------------------------------
// bf16, d_k in {16, 32}, D in {128, 256}, F = 128: every product on wgmma.

namespace enc_wgmma {

using namespace ::mmtx::wg;

constexpr int BN = 128;                      // columns of a pass
constexpr int kChunkBytes = BN * 128;        // a weight chunk: 128 rows x 64 columns
constexpr int kSlotBytes = 4 * kChunkBytes;  // a weight piece: 128 rows x K <= 256
constexpr int kSlots = 2;                    // the ring: one piece multiplied, one loading
constexpr int kTileBytes = BM * 256 * 2;     // a bf16 tile of 64 rows x D <= 256
constexpr int kStageLd = BN + 8;             // a staging row: 128 bf16 and 16 bytes
constexpr uint64_t kSwizzle128 = 1;          // descriptor mode: 128B
constexpr float kMaskedScore = -1e9f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSmem = 232448;             // 227 KB, a block's dynamic maximum

// The row chain's shared memory, from a 1024-byte aligned base: the ring of
// weight pieces; a bf16 tile (the attention output, swizzled as wgmma's A,
// then the staging of outputs); the fp32 residual rows [64][D + 4] (the 4
// spread a warp's fragment accesses over the banks); the ring's barriers.
constexpr int kTileOff = kSlots * kSlotBytes;
constexpr int kResOff = kTileOff + kTileBytes;
constexpr int chain_smem(int D) { return 1024 + kResOff + BM * (D + 4) * 4 + 8 * kSlots; }
static_assert(chain_smem(256) <= kMaxSmem, "the row chain's shared memory");

// What the chain starts from and where it ends: layer 0 (the stack's
// input -> LN1 + QKV), a middle layer (attention output -> ... -> the next
// layer's QKV) or the last (attention output -> ... -> the final norm).
enum ChainMode : int { kFirst = 0, kMiddle = 1, kLast = 2 };

// acc = A . piece^T over KS k steps on wgmma m64n128k16: A from registers
// (RS) or, for the out projection, the swizzled tile (SS).
template <int KS>
__device__ __forceinline__ void mma_piece(float (&acc)[64], const uint32_t (&a)[KS][4],
                                          uint32_t slot) {
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    wgmma_n128(acc, a[ks],
               smem_desc(slot + (ks / 4) * kChunkBytes + (ks % 4) * 32, 1024, kSwizzle128), ks);
  wg_commit();
  wg_wait<0>();
  fence_regs(acc);
}
template <int KS>
__device__ __forceinline__ void mma_piece_ss(float (&acc)[64], uint32_t tile, uint32_t slot) {
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    wgmma_n128_ss(acc, smem_desc(tile + (ks / 4) * (BM * 128) + (ks % 4) * 32, 1024, kSwizzle128),
                  smem_desc(slot + (ks / 4) * kChunkBytes + (ks % 4) * 32, 1024, kSwizzle128), ks);
  wg_commit();
  wg_wait<0>();
  fence_regs(acc);
}

// The bias of the thread's 16 column pairs of a pass (bias at its first
// column), loaded before the pass's product so the loads overlap it.
__device__ __forceinline__ void load_bias(float2 (&bv)[16], const bf16* bias, int t) {
#pragma unroll
  for (int j = 0; j < 16; ++j) bv[j] = load_pair(bias + 8 * j + 2 * t);
}

// The residual rows (res at the pass's first column) += acc + bias.
__device__ __forceinline__ void add_residual(const float (&acc)[64], const float2 (&bv)[16],
                                             float* res, int RS, const Rows& rw) {
  float* x0 = res + rw.r0 * RS + 2 * rw.t;
  float* x1 = x0 + 8 * RS;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float2* p0 = reinterpret_cast<float2*>(x0 + 8 * j);
    float2* p1 = reinterpret_cast<float2*>(x1 + 8 * j);
    const float2 o0 = *p0, o1 = *p1;
    *p0 = make_float2(o0.x + (acc[4 * j] + bv[j].x), o0.y + (acc[4 * j + 1] + bv[j].y));
    *p1 = make_float2(o1.x + (acc[4 * j + 2] + bv[j].x), o1.y + (acc[4 * j + 3] + bv[j].y));
  }
}

// One 128-column pass of values in the accumulator layout, rounded to
// bf16, out through the staging tile as 16-byte row pieces: out[m0 + r,
// 0 : 128] (out at the pass's first column), rows past M skipped.
__device__ __forceinline__ void store_pass(const float (&y)[64], bf16* stage, bf16* out,
                                           int ld, int m0, int M, const Rows& rw) {
  bf16* s0 = stage + rw.r0 * kStageLd + 2 * rw.t;
  bf16* s1 = s0 + 8 * kStageLd;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    *reinterpret_cast<uint32_t*>(s0 + 8 * j) = pack_bf16(y[4 * j], y[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(s1 + 8 * j) = pack_bf16(y[4 * j + 2], y[4 * j + 3]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BM * 16; i += kThreads) {
    const int r = i >> 4, ch = i & 15;
    if (m0 + r < M)
      *reinterpret_cast<uint4*>(out + (size_t)(m0 + r) * ld + 8 * ch) =
          *reinterpret_cast<const uint4*>(stage + r * kStageLd + 8 * ch);
  }
  __syncthreads();
}

// A weight matrix W [rows, K] as the ring loads it: its TMA map (boxes of
// 64 columns x 128 rows, 128-byte swizzle: one chunk of a piece) and bias.
struct Weight {
  CUtensorMap map;
  const bf16* bias;
};

struct ChainArgs {
  Weight wo, w1, w2;      // the layer's out projection and FFN
  Weight next[3];         // the next layer's q, k, v (not read on the last)
  const bf16* in;         // [M, D]: the stack's input x (first) or the attention output
  float* xres;            // [M, D] the fp32 residual stream
  const bf16* ln2a;       // the layer's norm 2
  const bf16* ln2b;
  const bf16* ln_a;       // the next layer's LN1, or on the last the final norm
  const bf16* ln_b;
  float q_scale;          // 1/sqrt(d_k): q's factor before its bf16 round
  bf16* qkv;              // [M, 3D]
  bf16* out;              // [M, D]: the stack's output (last)
  int M;
  int mode;               // ChainMode
};

// Weight piece i of a chain, in the order it multiplies: the out
// projection's D / 128 pieces, FFN1's F / 128, FFN2's D / 128 (K = F), then
// the next QKV's 3 D / 128 (the first layer's chain has only those).  Its
// weight, first row *n0 and K.
template <int D, int F>
__device__ __forceinline__ const Weight& chain_piece(const ChainArgs& c, int i, int* n0,
                                                     int* K) {
  *K = D;
  if (c.mode != kFirst) {
    if (i < D / 128) {
      *n0 = 128 * i;
      return c.wo;
    }
    i -= D / 128;
    if (i < F / 128) {
      *n0 = 128 * i;
      return c.w1;
    }
    i -= F / 128;
    if (i < D / 128) {
      *n0 = 128 * i;
      *K = F;
      return c.w2;
    }
    i -= D / 128;
  }
  *n0 = 128 * (i % (D / 128));
  const int m = i / (D / 128);
  return m == 0 ? c.next[0] : m == 1 ? c.next[1] : c.next[2];
}

// The row chain of one block of 64 rows.  Everything from a layer's
// attention output to the next layer's q, k and v is row-local: the out
// projection + residual, LN2, FFN1 + ReLU, FFN2 + residual, then the next
// layer's LN1 + QKV, or on the last layer the final norm into out; layer
// 0's chain is its LN1 + QKV alone.  The weight pieces stream through the
// ring by TMA (one thread issues a piece's K / 64 boxes on its slot's
// barrier), the next piece loading while one is multiplied.  The
// residual rows stay in shared memory in fp32 (from xres at the start, to
// xres before the next LN1); LN reads them where the thread's own
// fragment lies and rounds straight into A fragments in registers; FFN1's
// ReLU output is FFN2's A fragments without leaving registers; outputs
// leave through the staging tile as 16-byte rows.
template <int D, int F>
__global__ void __launch_bounds__(kThreads)
chain_kernel(const __grid_constant__ ChainArgs c) {
  constexpr int NP = D / 128, RS = D + 4;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  bf16* stage = reinterpret_cast<bf16*>(smem + kTileOff);
  float* res = reinterpret_cast<float*>(smem + kResOff);
  const uint32_t full0 = base + kResOff + BM * RS * 4;  // the ring's barriers
  const int m0 = blockIdx.x * BM, M = c.M;
  const Rows rw;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) mbar_init(full0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // commit group 0: the rows the chain starts from
  if (c.mode == kFirst) {  // x (bf16) -> the residual rows and xres
    for (int i = threadIdx.x; i < BM * D / 8; i += kThreads) {
      const int r = i / (D / 8), ch = i % (D / 8);
      const bool ok = m0 + r < M;
      const uint4 u = ok ? *reinterpret_cast<const uint4*>(c.in + (size_t)(m0 + r) * D + 8 * ch)
                         : make_uint4(0u, 0u, 0u, 0u);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
      const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
      const float2 f2 = __bfloat1622float2(h[2]), f3 = __bfloat1622float2(h[3]);
      const float4 lo = make_float4(f0.x, f0.y, f1.x, f1.y);
      const float4 hi = make_float4(f2.x, f2.y, f3.x, f3.y);
      float4* dst = reinterpret_cast<float4*>(res + r * RS + 8 * ch);
      dst[0] = lo;
      dst[1] = hi;
      if (ok) {
        float4* g = reinterpret_cast<float4*>(c.xres + (size_t)(m0 + r) * D + 8 * ch);
        g[0] = lo;
        g[1] = hi;
      }
    }
  } else {  // the attention output (wgmma's A, swizzled) and the residual rows
    load_swizzled<D>(smem + kTileOff, c.in + (size_t)m0 * D, M - m0);
    for (int i = threadIdx.x; i < BM * D / 4; i += kThreads) {
      const int r = i / (D / 4), ch = i % (D / 4);
      const bool ok = m0 + r < M;
      cp_async<16>(res + r * RS + 4 * ch, c.xres + (size_t)(ok ? m0 + r : 0) * D + 4 * ch, ok);
    }
  }
  cp_async_commit();
  __syncthreads();  // the barriers are initialised
  const int n_pieces = (c.mode == kFirst ? 0 : 2 * NP + F / 128) + (c.mode == kLast ? 0 : 3 * NP);
  int issued = 0;
  auto issue = [&]() {  // thread 0 loads the next piece into its slot
    if (threadIdx.x == 0 && issued < n_pieces) {
      int n0, K;
      const Weight& w = chain_piece<D, F>(c, issued, &n0, &K);
      const uint32_t slot = base + (issued % kSlots) * kSlotBytes;
      const uint32_t full = full0 + 8 * (issued % kSlots);
      mbar_arrive_tx(full, 128 * K * 2);
      for (int ch = 0; ch < K / 64; ++ch)
        tma_load_2d(slot + ch * kChunkBytes, &w.map, 64 * ch, n0, full);
    }
    ++issued;
  };
#pragma unroll
  for (int s = 0; s < kSlots; ++s) issue();
  cp_async_wait<0>();  // the rows the chain starts from, for every thread
  fence_proxy_async();
  __syncthreads();
  int piece = 0;
  auto ready = [&]() {  // piece `piece` has landed
    mbar_wait(full0 + 8 * (piece % kSlots), (piece / kSlots) & 1);
    return base + (piece % kSlots) * kSlotBytes;
  };
  auto release = [&]() {  // its slot is free: load the piece kSlots on
    __syncthreads();
    ++piece;
    issue();
  };

  float acc[64];
  float2 bv[16];
  uint32_t a[8 * NP][4];
  float v[NP][64];
  if (c.mode != kFirst) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {  // out projection + residual
      load_bias(bv, c.wo.bias + 128 * p, rw.t);
      mma_piece_ss<D / 16>(acc, base + kTileOff, ready());
      release();
      add_residual(acc, bv, res + 128 * p, RS, rw);
    }
    read_rows(v, res, RS, rw);  // LN2 (the thread's own values)
    layer_norm(v, c.ln2a, c.ln2b, rw.t);
    to_frags(v, a);
    uint32_t h[F / 16][4];  // FFN1's ReLU output: FFN2's A fragments
#pragma unroll
    for (int q = 0; q < F / 128; ++q) {
      load_bias(bv, c.w1.bias + 128 * q, rw.t);
      mma_piece(acc, a, ready());
      release();
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        h[8 * q + j / 2][2 * (j % 2)] = pack_bf16(fmaxf(acc[4 * j] + bv[j].x, 0.f),
                                                  fmaxf(acc[4 * j + 1] + bv[j].y, 0.f));
        h[8 * q + j / 2][2 * (j % 2) + 1] = pack_bf16(fmaxf(acc[4 * j + 2] + bv[j].x, 0.f),
                                                      fmaxf(acc[4 * j + 3] + bv[j].y, 0.f));
      }
    }
#pragma unroll
    for (int p = 0; p < NP; ++p) {  // FFN2 + residual
      load_bias(bv, c.w2.bias + 128 * p, rw.t);
      mma_piece(acc, h, ready());
      release();
      add_residual(acc, bv, res + 128 * p, RS, rw);
    }
    if (c.mode == kMiddle) {  // the residual rows back to xres, 16 bytes a thread
      __syncthreads();
      for (int i = threadIdx.x; i < BM * D / 4; i += kThreads) {
        const int r = i / (D / 4), ch = i % (D / 4);
        if (m0 + r < M)
          *reinterpret_cast<float4*>(c.xres + (size_t)(m0 + r) * D + 4 * ch) =
              *reinterpret_cast<const float4*>(res + r * RS + 4 * ch);
      }
    }
  }
  read_rows(v, res, RS, rw);  // the next LN1, or the final norm
  layer_norm(v, c.ln_a, c.ln_b, rw.t);
  if (c.mode == kLast) {
#pragma unroll
    for (int p = 0; p < NP; ++p) store_pass(v[p], stage, c.out + 128 * p, D, m0, M, rw);
    return;
  }
  to_frags(v, a);
  for (int p = 0; p < 3 * NP; ++p) {  // QKV, q scaled before its bf16 round
    const int m = p / NP;  // q, k or v (no runtime index into the parameters)
    load_bias(bv, (m == 0 ? c.next[0] : m == 1 ? c.next[1] : c.next[2]).bias + 128 * (p % NP),
              rw.t);
    mma_piece(acc, a, ready());
    release();
    const float s = 128 * p < D ? c.q_scale : 1.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      acc[4 * j] = (acc[4 * j] + bv[j].x) * s;
      acc[4 * j + 1] = (acc[4 * j + 1] + bv[j].y) * s;
      acc[4 * j + 2] = (acc[4 * j + 2] + bv[j].x) * s;
      acc[4 * j + 3] = (acc[4 * j + 3] + bv[j].y) * s;
    }
    store_pass(acc, stage, c.qkv + 128 * p, 3 * D, m0, M, rw);
  }
}

// Attention of one (64-query tile, head, video) over all its keys.  qkv is
// [B, T, 3D] with q already scaled; K and V of the head come whole into
// shared memory by TMA as boxes of 64 keys (rows of DK * 2 bytes, swizzled
// over them, as TMA writes them and wgmma reads them), the video's key
// mask by cp.async beside them; key tile it of n_tiles holds NT boxes.
// The output [B, T, D] leaves through a staging tile as 16-byte rows.
template <int DK, int NT>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const __grid_constant__ CUtensorMap tm, const bf16* __restrict__ qkv,
                 const float* __restrict__ kmask, bf16* __restrict__ out, int T, int D,
                 int n_tiles) {
  constexpr int KS = DK / 16;                  // k steps of q.k^T
  constexpr int NO = DK / 2;                   // output accumulators a thread
  constexpr int kBoxBytes = 64 * DK * 2;
  constexpr int kGroupBytes = 8 * DK * 2;      // 8 key rows: the descriptors' stride
  constexpr uint64_t kSwizzle = DK == 32 ? 2 : 3;  // 64B or 32B
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const int boxes = n_tiles * NT;
  const int live = (T + 63) / 64;              // boxes that start below T
  const uint32_t kbase = base, vbase = base + boxes * kBoxBytes;
  float* mk = reinterpret_cast<float*>(smem + 2 * boxes * kBoxBytes);  // the key mask
  const uint32_t bar = base + 2 * boxes * kBoxBytes + boxes * 64 * 4;

  const int b = blockIdx.z, hd = blockIdx.y, q0 = blockIdx.x * 64;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;

  // zeros in the boxes past the keys, then the loads of the others
  for (int i = live * kBoxBytes / 16 + tid; i < boxes * kBoxBytes / 16; i += kThreads) {
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
    reinterpret_cast<uint4*>(smem + boxes * kBoxBytes)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_tx(bar, 2 * live * kBoxBytes);
    for (int i = 0; i < live; ++i) {
      tma_load(kbase + i * kBoxBytes, &tm, D + hd * DK, 64 * i, b, bar);
      tma_load(vbase + i * kBoxBytes, &tm, 2 * D + hd * DK, 64 * i, b, bar);
    }
  }
  // the key mask by cp.async, zeros past T
  const float* km = kmask + (size_t)b * T;
  for (int i = tid; i < boxes * 64; i += kThreads)
    cp_async<4>(mk + i, km + (i < T ? i : 0), i < T);
  cp_async_commit();

  // q's fragments (rows r0 and r1, columns 16 ks + 2 t, + 1, + 8, + 9)
  const size_t rs = 3 * (size_t)D;
  const bf16* qb = qkv + (size_t)b * T * rs + hd * DK;
  const int r0 = q0 + 16 * warp + g, r1 = r0 + 8;
  auto qld = [&](int r, int col) -> uint32_t {
    return r < T ? *reinterpret_cast<const uint32_t*>(qb + (size_t)r * rs + col) : 0u;
  };
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int col = 16 * ks + 2 * t;
    qa[ks][0] = qld(r0, col);
    qa[ks][1] = qld(r1, col);
    qa[ks][2] = qld(r0, col + 8);
    qa[ks][3] = qld(r1, col + 8);
  }

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m0 = kMaskedScore, m1 = kMaskedScore, l0 = 0.f, l1 = 0.f;
  mbar_wait(bar, 0);
  cp_async_wait<0>();
  __syncthreads();  // every thread's part of the mask

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * NT * 64;
    // s[c][4 j + e]: row r0, key k0 + 64 c + 8 j + 2 t + e; s[c][4 j + 2 + e]: row r1
    float s[NT][32];
#pragma unroll
    for (int c = 0; c < NT; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) s[c][i] = 0.f;
    wg_fence();
#pragma unroll
    for (int c = 0; c < NT; ++c)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        wgmma_n64(s[c], qa[ks],
                  smem_desc(kbase + (it * NT + c) * kBoxBytes + 32 * ks, kGroupBytes, kSwizzle),
                  ks);
    wg_commit();
    // the tile's keys as bit words (key 32 w + bit): kept, and below T
    uint32_t kw[2 * NT], lw[2 * NT];
#pragma unroll
    for (int w = 0; w < 2 * NT; ++w) {
      const int key = k0 + 32 * w + lane;
      kw[w] = __ballot_sync(0xffffffffu, mk[key] != 0.f);
      lw[w] = __ballot_sync(0xffffffffu, key < T);
    }
    wg_wait<0>();
#pragma unroll
    for (int c = 0; c < NT; ++c) fence_regs(s[c]);

    uint32_t all = 0xffffffffu;
#pragma unroll
    for (int w = 0; w < 2 * NT; ++w) all &= kw[w];
    if (all != 0xffffffffu) {  // a key masked (-1e9) or past T (-inf)
#pragma unroll
      for (int c = 0; c < NT; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int w = 2 * c + (j >> 2), bit = 8 * (j & 3) + 2 * t + e;
            if (!((kw[w] >> bit) & 1u)) {
              const float fill = ((lw[w] >> bit) & 1u) ? kMaskedScore : -INFINITY;
              s[c][4 * j + e] = fill;
              s[c][4 * j + 2 + e] = fill;
            }
          }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int c = 0; c < NT; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[c][4 * j], s[c][4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[c][4 * j + 2], s[c][4 * j + 3]));
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // the 4 threads of a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // every tile holds a key below T, so mx >= -1e9 and the new max is finite
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = ex2((m0 - mn0) * kLog2e), a1 = ex2((m1 - mn1) * kLog2e);
    m0 = mn0;
    m1 = mn1;
    const float ml0 = mn0 * kLog2e, ml1 = mn1 * kLog2e;
    // p = 2^(s log2 e - m log2 e); the sums take p in fp32, p.v in bf16:
    // pa[kk] is the A fragment of the 16-key step kk
    uint32_t pa[4 * NT][4];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int c = 0; c < NT; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p0 = ex2(fmaf(s[c][4 * j], kLog2e, -ml0));
        const float p1 = ex2(fmaf(s[c][4 * j + 1], kLog2e, -ml0));
        const float p2 = ex2(fmaf(s[c][4 * j + 2], kLog2e, -ml1));
        const float p3 = ex2(fmaf(s[c][4 * j + 3], kLog2e, -ml1));
        sum0 += p0 + p1;
        sum1 += p2 + p3;
        const int kk = 4 * c + (j >> 1), hf = j & 1;
        pa[kk][2 * hf] = pack_bf16(p0, p1);
        pa[kk][2 * hf + 1] = pack_bf16(p2, p3);
      }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      o[4 * j] *= a0;
      o[4 * j + 1] *= a0;
      o[4 * j + 2] *= a1;
      o[4 * j + 3] *= a1;
    }
    // o += p V over the tile's 16-key steps (keys past T: p = 0, V = 0)
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NT; ++kk)
      wgmma_pv<DK>(o, pa[kk],
                   smem_desc(vbase + (it * NT * 64 + 16 * kk) * DK * 2, kGroupBytes, kSwizzle));
    wg_commit();
    wg_wait<0>();
    fence_regs(o);
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  // out through a staging tile over the K and V boxes (every product on
  // them has completed) as 16-byte row pieces
  constexpr int kOutLd = DK * 2 + 16;  // bytes a staging row
  __syncthreads();
  uint8_t* s0 = smem + (16 * warp + g) * kOutLd + 4 * t;
  uint8_t* s1 = s0 + 8 * kOutLd;
#pragma unroll
  for (int j = 0; j < NO / 4; ++j) {
    *reinterpret_cast<uint32_t*>(s0 + 16 * j) = pack_bf16(o[4 * j] / l0, o[4 * j + 1] / l0);
    *reinterpret_cast<uint32_t*>(s1 + 16 * j) = pack_bf16(o[4 * j + 2] / l1, o[4 * j + 3] / l1);
  }
  __syncthreads();
  constexpr int CPR = DK * 2 / 16;  // 16-byte pieces a row
  bf16* ob = out + (size_t)b * T * D + hd * DK;
  for (int i = tid; i < 64 * CPR; i += kThreads) {
    const int r = i / CPR, ch = i % CPR;
    if (q0 + r < T)
      *reinterpret_cast<uint4*>(ob + (size_t)(q0 + r) * D + 8 * ch) =
          *reinterpret_cast<const uint4*>(smem + r * kOutLd + 16 * ch);
  }
}

// The attention block's dynamic shared memory: 2 n_tiles NT boxes, their
// keys' mask, the barrier and 1024 bytes of alignment slack.
inline int attention_smem(int DK, int NT, int n_tiles) {
  return n_tiles * NT * 64 * (2 * DK * 2 + 4) + 8 + 1024;
}

template <typename Kernel>
int allow_smem(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D, int F>
int launch_chain(const ChainArgs& c, cudaStream_t st) {
  const auto kernel = chain_kernel<D, F>;
  static int setup = -1;  // cudaError_t of the one-time set-up
  if (setup < 0) setup = allow_smem(kernel, chain_smem(D));
  if (setup != 0) return setup;
  kernel<<<(c.M + BM - 1) / BM, kThreads, chain_smem(D), st>>>(c);
  return (int)cudaGetLastError();
}

int chain(int D, const ChainArgs& c, cudaStream_t st) {
  return D == 128 ? launch_chain<128, 128>(c, st) : launch_chain<256, 128>(c, st);
}

template <int DK, int NT>
int launch_attention(const CUtensorMap& tm, const bf16* qkv, const float* kmask, bf16* out,
                     int B, int T, int D, int H, cudaStream_t st) {
  const auto kernel = attention_kernel<DK, NT>;
  static int setup = -1;
  if (setup < 0) setup = allow_smem(kernel, kMaxSmem);
  if (setup != 0) return setup;
  const int n_tiles = (T + 64 * NT - 1) / (64 * NT);
  const int smem = attention_smem(DK, NT, n_tiles);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const dim3 grid((T + 63) / 64, H, B);
  kernel<<<grid, kThreads, smem, st>>>(tm, qkv, kmask, out, T, D, n_tiles);
  return (int)cudaGetLastError();
}

template <int DK>
int attention(int nt, const CUtensorMap& tm, const bf16* qkv, const float* kmask, bf16* out,
              int B, int T, int D, int H, cudaStream_t st) {
  switch (nt) {
    case 1: return launch_attention<DK, 1>(tm, qkv, kmask, out, B, T, D, H, st);
    case 2: return launch_attention<DK, 2>(tm, qkv, kmask, out, B, T, D, H, st);
    case 3: return launch_attention<DK, 3>(tm, qkv, kmask, out, B, T, D, H, st);
    default: return launch_attention<DK, 4>(tm, qkv, kmask, out, B, T, D, H, st);
  }
}

// One stack in 2 N + 1 launches: layer 0's chain (LN1 + QKV), then per
// layer the attention and the row chain.  nt: 64-key boxes per score tile
// (1..4, the wrapper's key_tiles).
int run_stack(const bf16* x, const float* kmask, bf16* out, const void* const* lp,
              int n_layers, const bf16* fa, const bf16* fb, float* xres, bf16* qkv,
              bf16* attn, int B, int T, int D, int H, int F, int nt, cudaStream_t st) {
  const int M = B * T;
  const int dk = D / H;
  if (dk * H != D || (dk != 16 && dk != 32) || (D != 128 && D != 256) || F != 128 ||
      nt < 1 || nt > 4)
    return (int)cudaErrorInvalidValue;
  if (n_layers == 0) {
    enc::ln_rows<bf16, bf16, bf16>(x, fa, fb, out, nullptr, M, D, st);
    return (int)cudaGetLastError();
  }
  CUtensorMap tm;
  if (!heads_map(&tm, qkv, B, T, 3 * D, dk)) return (int)cudaErrorInvalidValue;
  // p: ln1a ln1b wq bq wk bk wv bv wo bo ln2a ln2b w1 b1 w2 b2
  auto param = [&](int l, int i) { return static_cast<const bf16*>(lp[16 * l + i]); };
  auto weight = [&](Weight* w, int l, int i, int rows, int K) {  // p[i + 1] is its bias
    w->bias = param(l, i + 1);
    return tile_map(&w->map, param(l, i), rows, K, 128);
  };
  ChainArgs c{};
  c.xres = xres;
  c.q_scale = 1.0f / sqrtf((float)dk);
  c.qkv = qkv;
  c.out = out;
  c.M = M;
  auto next_layer = [&](int l) {  // its LN1 and QKV
    c.ln_a = param(l, 0);
    c.ln_b = param(l, 1);
    bool ok = true;
    for (int m = 0; m < 3; ++m) ok = weight(&c.next[m], l, 2 + 2 * m, D, D) && ok;
    return ok;
  };
  c.mode = kFirst;
  c.in = x;
  int rc = next_layer(0) ? chain(D, c, st) : (int)cudaErrorInvalidValue;
  for (int l = 0; l < n_layers && rc == 0; ++l) {
    rc = dk == 32 ? attention<32>(nt, tm, qkv, kmask, attn, B, T, D, H, st)
                  : attention<16>(nt, tm, qkv, kmask, attn, B, T, D, H, st);
    if (rc != 0) break;
    c.mode = l + 1 == n_layers ? kLast : kMiddle;
    c.in = attn;
    c.ln2a = param(l, 10);
    c.ln2b = param(l, 11);
    bool ok = weight(&c.wo, l, 8, D, D) && weight(&c.w1, l, 12, F, D) &&
              weight(&c.w2, l, 14, D, F);
    if (c.mode == kLast) {
      c.ln_a = fa;
      c.ln_b = fb;
    } else {
      ok = next_layer(l + 1) && ok;
    }
    rc = ok ? chain(D, c, st) : (int)cudaErrorInvalidValue;
  }
  return rc;
}

}  // namespace enc_wgmma
}  // namespace mmtx

// The path of (dtype, d_k, D, F), as the wrapper's kernel_path chooses it:
// 1 (wgmma) for bf16 at d_k in {16, 32}, D in {128, 256} and F = 128, else 0.
static int wgmma_path(int dtype, int D, int H, int F) {
  const int dk = H > 0 ? D / H : 0;
  return dtype == mmtx::kBF16 && dk * H == D && (dk == 16 || dk == 32) &&
         (D == 128 || D == 256) && F == 128;
}

// C entry.  path: 0 FMA pipes (fp32, or bf16 off the wgmma tiling), 1 wgmma
// (see wgmma_path; the wrapper's kernel_path); any other is refused.  All
// tensors contiguous and 16-byte aligned; x/out [B, T, D]; kmask [B, T]
// fp32; layer_ptrs holds 16 device pointers per layer (see enc::run_stack);
// scratch: xres fp32 [B*T, D], qkv [B*T, 3D] and attn [B*T, D] in the
// storage dtype, and (path 0 only, else unused) mid [B*T, F] and xn
// [B*T, D]; key_sub: 64-key boxes per attention score tile (path 1,
// 1..4).  Returns
// cudaGetLastError() after the launches, or the error of a set-up step.
extern "C" int mmtx_encoder_stack(int path, int dtype, const void* x, const void* kmask,
                                  void* out, const void* layer_ptrs, int n_layers,
                                  const void* fnorm_a, const void* fnorm_b,
                                  void* xres, void* xn, void* qkv, void* attn,
                                  void* mid, int B, int T, int D, int H, int F,
                                  int key_sub, void* stream) {
  using namespace mmtx;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* const* lp = static_cast<const void* const*>(layer_ptrs);
  const float* km = static_cast<const float*>(kmask);
  float* xr = static_cast<float*>(xres);
  if (B < 1 || T < 1 || path != wgmma_path(dtype, D, H, F)) return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  if (path == 1) {
    return enc_wgmma::run_stack(
        static_cast<const bf*>(x), km, static_cast<bf*>(out), lp, n_layers,
        static_cast<const bf*>(fnorm_a), static_cast<const bf*>(fnorm_b), xr,
        static_cast<bf*>(qkv), static_cast<bf*>(attn), B, T, D, H, F, key_sub, st);
  }
  if (dtype == kF32) {
    return enc::run_stack<float>(
        static_cast<const float*>(x), km, static_cast<float*>(out), lp, n_layers,
        static_cast<const float*>(fnorm_a), static_cast<const float*>(fnorm_b), xr,
        static_cast<float*>(xn), static_cast<float*>(qkv), static_cast<float*>(attn),
        static_cast<float*>(mid), B, T, D, H, F, st);
  }
  if (dtype == kBF16) {
    return enc::run_stack<bf>(
        static_cast<const bf*>(x), km, static_cast<bf*>(out), lp, n_layers,
        static_cast<const bf*>(fnorm_a), static_cast<const bf*>(fnorm_b), xr,
        static_cast<bf*>(xn), static_cast<bf*>(qkv), static_cast<bf*>(attn),
        static_cast<bf*>(mid), B, T, D, H, F, st);
  }
  return (int)cudaErrorInvalidValue;
}
