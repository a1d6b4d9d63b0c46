// Kernel 10: the window embed of the front end -- Conv1d(k=2) over each
// window's frames, max over the conv axis, then the Highway gate -- in one
// pass.
//
// Replaces: multimodal_transformer_tpu/ops/pallas/window_embed.py
//   fused_window_embed_highway (body _kernel), which is also the forward of
//   window_embed_highway_trainable.
//
// x [N, F, D] (N = B*W windows, F >= 2 frames) -> out [N, E]:
//   conv[n, f] = x[n, f] . W0 + x[n, f+1] . W1 + b        (f = 0 .. F-2)
//   pooled[n]  = max_f conv[n, f]
//   out[n]     = g * (pooled . Wp^T + bp) + (1 - g) * pooled,
//                g = sigmoid(pooled . Wg^T + bg)
// with the conv weight [E, D, 2] and the highway linears [E, E] in torch
// layout.  Rounding points follow the TPU kernel: products of storage-dtype
// inputs with fp32 accumulation; conv, pooled and both highway products in
// fp32; only out is rounded to the storage dtype.
//
// What bounds it on the H100: at the MFT A+V+L front end (B=32, T=160, so
// N = 5,120 windows; linguistic F=32, D=E=300; image F=4, D=1000, E=256;
// acoustic F=4, D=E=88) the conv products are ~73 GFLOP against ~143 MB of
// bf16 input, about 510 operations per byte, so it is compute-bound: the
// bf16 conv products belong on the tensor cores, and the fp32 highway
// products (~3.3 GFLOP) run on the FMA pipes, at the same time as far as
// the bound goes.  In fp32 every product runs on the FMA pipes.
//
// What the design does about it:
//   * The pairs are free.  Pair row (n, f) of the conv is [x[n, f], x[n, f+1]],
//     which in the contiguous [N, F, D] layout is the 2D values starting at
//     frame f of window n.  So the conv is one GEMM [N*(F-1), 2D] x [2D, E]
//     whose A rows overlap in memory: nothing is concatenated, and the
//     [N, F-1, E] conv tensor never leaves the block.
//   * A block owns TN whole windows, so frame f+1 of one window never pairs
//     with the next window's frame 0 and the max over f stays in the block.
//     Its TN*(F-1) pair rows run in 128-row tiles, which may split a window
//     (linguistic: 31 pairs a window); each tile's max over f joins the
//     block's pooled [TN, E] rows (fp32, shared memory) as a running max.
//     It walks E in tiles of EN channels.
//   * bf16 products run on the tensor cores (mma.sync m16n8k16, fp32
//     accumulation, 128-channel tiles); fp32 products on the FMA pipes (no
//     TF32: it would move the rounding points), 8 rows x EN/16 channels a
//     thread read as float4 and float2 from shared memory, with EN (96, 128
//     or 160) the width that pads E least: 160 for E=300, not 3 x 128.
//   * The highway then runs in the same block from the pooled rows in
//     shared memory, on the FMA pipes in fp32 as the rounding points ask:
//     a warp owns 5 windows x EN channels, the weights stream through
//     shared memory in 32-deep k slices, and the next slice's loads are in
//     flight while the current one is multiplied.
//   * Ragged edges in N, D and E are masked in the loads; padded windows of
//     zeros are computed like any other (their output is the highway of the
//     bias, masked downstream).
//   * The k loop keeps kStages - 1 stages of cp.async copies in flight.  The
//     number of copy instructions, more than their latency, limits the loop,
//     so bf16 tiles copy 8 bytes of x and 16 bytes of [W0 | W1] at a time
//     when D is a multiple of 4 (every front end's), value by value
//     otherwise.
// A simple version: no TMA, no wgmma, one block per SM.

#include <initializer_list>
#include <type_traits>

#include "common.cuh"

namespace mmtx {
namespace wembed {

constexpr int PM = 128;       // pair rows per conv tile
constexpr int kThreads = 256;
constexpr int BK16 = 32;      // k depth per stage, bf16 (two m16n8k16 steps)
constexpr int BKP16 = BK16 + 8;
constexpr int BK32 = 16;      // k depth per stage, fp32
constexpr int KC = 32;        // highway k depth per weight slice
constexpr int HJ = 5;         // highway windows per warp and pass (8 HJ per pass)
constexpr int kRowsPerThread = PM * 16 / kThreads;  // = 8 (fp32 tile)

constexpr int kStages = 3;    // copies in flight: kStages - 1

__host__ __device__ constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

// Shared memory of a block before its pooled rows: the conv tile's stages,
// then its [PM][EN + 1] fp32 results, then the highway's two weight slices
// [EN][KC + 1], one after the other in the same bytes.
template <typename T, int EN>
struct Tile {
  static constexpr int LDA = PM + 4, LDB = EN + 4;  // fp32 stage rows, floats
  static constexpr size_t kStage =
      std::is_same<T, float>::value
          ? (size_t)BK32 * (LDA + LDB) * sizeof(float)
          : 2 * (size_t)PM * BKP16 * sizeof(__nv_bfloat16);  // A + B
  static constexpr size_t kBytes =
      cmax(cmax(kStages * kStage, (size_t)PM * (EN + 1) * sizeof(float)),
           2 * (size_t)EN * (KC + 1) * sizeof(float));
  static_assert(kStage % 16 == 0 && kBytes % 16 == 0, "16-byte aligned stages");
  static_assert(EN % 32 == 0 && (EN * KC) % kThreads == 0, "highway layout");
};
constexpr size_t kMaxSmem = 232448;

// The k loop of a conv tile over `steps` stages of shared memory: the
// copies of the next kStages - 1 stages are in flight while stage s is
// multiplied.  load(buf, step) issues the copies of k step `step` into
// buffer buf; compute(buf) multiplies it.  Returns with every copy landed
// and every thread done with the buffers.
template <typename Load, typename Compute>
__device__ __forceinline__ void pipelined(int steps, Load load, Compute compute) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();  // stage s has landed
    __syncthreads();               // ... for every thread; stage s-1 is free
    const int next = s + kStages - 1;
    if (next < steps) load(next % kStages, next);
    cp_async_commit();
    compute(s % kStages);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The block's pair rows: row p of the block is [x[n0 + p / (F-1), p % (F-1)],
// the next frame], 2D contiguous values.
template <typename T>
struct PairRows {
  const T* x;
  int n0, F, D, P;
  __device__ __forceinline__ const T* row(int p) const {
    return p < P ? x + ((size_t)(n0 + p / (F - 1)) * F + p % (F - 1)) * D : nullptr;
  }
};

// One conv tile: pair rows [r0, r0 + PM) x channels [e0, e0 + EN) over the
// K = 2D reduction, into cs[PM][EN + 1] (fp32, bias added); kcat is
// [E, 2D] = [W0 | W1].
// bf16: tensor cores (mma.sync m16n8k16, fp32 accumulation).  With vec (D a
// multiple of 4, x 8-byte aligned) the pair rows copy 8 bytes and the weight
// rows 16 bytes at a time; otherwise value by value.
template <int EN>
__device__ void conv_tile(const PairRows<__nv_bfloat16>& rows, int r0,
                          const __nv_bfloat16* __restrict__ kcat,
                          const __nv_bfloat16* __restrict__ cb, int e0, int E, bool vec,
                          char* tile) {
  static_assert(EN == 128, "bf16 tiles are 128 channels wide");
  using bf = __nv_bfloat16;
  typedef bf Stage[2][PM][BKP16];  // [A | B][row][k]
  Stage* st = reinterpret_cast<Stage*>(tile);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: 64 rows x 32 channels
  const int K = 2 * rows.D;
  // vec: this thread copies 4 values of pair rows t/8 + 32 l (l < 4) and 8
  // values of weight rows t/4 + 64 l (l < 2)
  const bf* arow[4];
#pragma unroll
  for (int l = 0; l < 4; ++l) arow[l] = rows.row(r0 + (t >> 3) + 32 * l);
  const int ka = 4 * (t & 7), kb = 8 * (t & 3);
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  auto load = [&](int buf, int step) {
    const int k0 = step * BK16;
    if (vec) {
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const int k = k0 + ka;
        const bool ok = arow[l] != nullptr && k < K;
        cp_async<8>(&st[buf][0][(t >> 3) + 32 * l][ka], ok ? arow[l] + k : kcat, ok);
      }
#pragma unroll
      for (int l = 0; l < 2; ++l) {
        const int c = (t >> 2) + 64 * l, k = k0 + kb;
        const bool ok = e0 + c < E && k < K;
        cp_async<16>(&st[buf][1][c][kb], ok ? kcat + (size_t)(e0 + c) * K + k : kcat, ok);
      }
      return;
    }
    const bf zero = __float2bfloat16_rn(0.f);
    for (int i = t; i < PM * BK16; i += kThreads) {
      const int r = i / BK16, kk = i % BK16, k = k0 + kk;
      const bf* a = rows.row(r0 + r);
      st[buf][0][r][kk] = a != nullptr && k < K ? a[k] : zero;
      st[buf][1][r][kk] = e0 + r < E && k < K ? kcat[(size_t)(e0 + r) * K + k] : zero;
    }
  };
  auto compute = [&](int buf) {
    const bf(*As)[BKP16] = st[buf][0];
    const bf(*Bs)[BKP16] = st[buf][1];
#pragma unroll
    for (int ks = 0; ks < BK16; ks += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int rr = wm * 64 + mi * 16 + g;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(&As[rr][ks + 2 * tig]);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(&As[rr + 8][ks + 2 * tig]);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(&As[rr][ks + 2 * tig + 8]);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(&As[rr + 8][ks + 2 * tig + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int cc = wn * 32 + ni * 8 + g;
        b[ni][0] = *reinterpret_cast<const uint32_t*>(&Bs[cc][ks + 2 * tig]);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(&Bs[cc][ks + 2 * tig + 8]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
    }
  };
  pipelined((K + BK16 - 1) / BK16, load, compute);
  float(*cs)[EN + 1] = reinterpret_cast<float(*)[EN + 1]>(tile);
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int c = wn * 32 + ni * 8 + 2 * tig;
    const float b0 = e0 + c < E ? to_f(cb[e0 + c]) : 0.f;
    const float b1 = e0 + c + 1 < E ? to_f(cb[e0 + c + 1]) : 0.f;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int r = wm * 64 + mi * 16 + g;
      cs[r][c] = acc[mi][ni][0] + b0;
      cs[r][c + 1] = acc[mi][ni][1] + b1;
      cs[r + 8][c] = acc[mi][ni][2] + b0;
      cs[r + 8][c + 1] = acc[mi][ni][3] + b1;
    }
  }
}

// fp32: the same tile on the FMA pipes.  A thread owns pair rows 4 ty + i
// and 64 + 4 ty + i (i < 4), read as two float4 per k, and channels
// 2 tx + 32 j + {0, 1} (j < EN / 32), read as float2; it copies value
// t % 16 of pair rows t / 16 + 16 l and of weight rows t / 16 + 16 l.
template <int EN>
__device__ void conv_tile(const PairRows<float>& rows, int r0, const float* __restrict__ kcat,
                          const float* __restrict__ cb, int e0, int E, bool, char* tile) {
  constexpr int NC = EN / 16;  // channels per thread
  constexpr int LDA = Tile<float, EN>::LDA, LDB = Tile<float, EN>::LDB;
  constexpr int kStageFloats = BK32 * (LDA + LDB);  // [A: k x row | B: k x channel]
  float* st = reinterpret_cast<float*>(tile);
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int K = 2 * rows.D;
  const float* arow[kRowsPerThread];
#pragma unroll
  for (int l = 0; l < kRowsPerThread; ++l) arow[l] = rows.row(r0 + ty + 16 * l);
  float acc[8][NC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

  auto load = [&](int buf, int step) {
    float* As = st + buf * kStageFloats;
    float* Bs = As + BK32 * LDA;
    const int k = step * BK32 + tx;
#pragma unroll
    for (int l = 0; l < kRowsPerThread; ++l) {
      const bool ok = arow[l] != nullptr && k < K;
      cp_async<4>(&As[tx * LDA + ty + 16 * l], ok ? arow[l] + k : kcat, ok);
    }
#pragma unroll
    for (int l = 0; l < NC; ++l) {
      const int c = ty + 16 * l, e = e0 + c;
      const bool ok = e < E && k < K;
      cp_async<4>(&Bs[tx * LDB + c], ok ? kcat + (size_t)e * K + k : kcat, ok);
    }
  };
  auto compute = [&](int buf) {
    const float* As = st + buf * kStageFloats;
    const float* Bs = As + BK32 * LDA;
#pragma unroll
    for (int kk = 0; kk < BK32; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk * LDA + 4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk * LDA + 64 + 4 * ty]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float bv[NC];
#pragma unroll
      for (int j = 0; j < NC / 2; ++j) {
        const float2 b = *reinterpret_cast<const float2*>(&Bs[kk * LDB + 2 * tx + 32 * j]);
        bv[2 * j] = b.x;
        bv[2 * j + 1] = b.y;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  };
  pipelined((K + BK32 - 1) / BK32, load, compute);
  float(*cs)[EN + 1] = reinterpret_cast<float(*)[EN + 1]>(tile);
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = 2 * tx + 32 * (j / 2) + (j & 1);
    const float b = e0 + c < E ? cb[e0 + c] : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) cs[(i < 4 ? 0 : 60) + 4 * ty + i][c] = acc[i][j] + b;
  }
}

template <typename T, int EN>
__global__ void __launch_bounds__(kThreads)
window_embed_kernel(const T* __restrict__ x, const T* __restrict__ kcat,
                    const T* __restrict__ cb, const T* __restrict__ wp,
                    const T* __restrict__ bp, const T* __restrict__ wg,
                    const T* __restrict__ bg, T* __restrict__ out, int N, int F,
                    int D, int E, int TN) {
  extern __shared__ __align__(16) char smem[];
  char* tile = smem;
  float* pooled = reinterpret_cast<float*>(smem + Tile<T, EN>::kBytes);  // [TN][E]
  const int t = threadIdx.x;
  const int n0 = blockIdx.x * TN;
  const int nw = min(TN, N - n0);
  const int pairs = F - 1;
  const int P = nw * pairs;
  const PairRows<T> rows{x, n0, F, D, P};
  const bool vec = (D & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 7) == 0;

  for (int i = t; i < nw * E; i += kThreads) pooled[i] = -INFINITY;
  __syncthreads();

  // conv + max over f, tile by tile
  for (int e0 = 0; e0 < E; e0 += EN) {
    for (int r0 = 0; r0 < P; r0 += PM) {
      conv_tile<EN>(rows, r0, kcat, cb, e0, E, vec, tile);
      __syncthreads();
      const float(*cs)[EN + 1] = reinterpret_cast<const float(*)[EN + 1]>(tile);
      const int rend = min(r0 + PM, P);
      const int w_lo = r0 / pairs, w_hi = (rend - 1) / pairs;  // windows in the tile
      for (int i = t; i < (w_hi - w_lo + 1) * EN; i += kThreads) {
        const int w = w_lo + i / EN, c = i % EN, e = e0 + c;
        if (e >= E) continue;
        const int lo = max(w * pairs, r0), hi = min((w + 1) * pairs, rend);
        float m = pooled[w * E + e];
        for (int r = lo; r < hi; ++r) m = fmaxf(m, cs[r - r0][c]);
        pooled[w * E + e] = m;
      }
      __syncthreads();
    }
  }

  // highway: warp wl owns windows w0 + wl + 8 j (j < HJ), lane owns channels
  // e0 + lane + 32 c (c < HC); the weights pass through shared memory as
  // [proj | gate][EN channels][KC k] slices, the next slice's values held in
  // registers while the current one is multiplied
  constexpr int HC = EN / 32;
  constexpr int kLoads = EN * KC / kThreads;  // slice values per thread and matrix
  typedef float Slice[EN][KC + 1];
  Slice* ws = reinterpret_cast<Slice*>(tile);
  const int lane = t & 31, wl = t >> 5;
  const int slices = (E + KC - 1) / KC;
  const T zero = from_f<T>(0.f);
  for (int e0 = 0; e0 < E; e0 += EN) {
    for (int w0 = 0; w0 < nw; w0 += 8 * HJ) {
      float ap[HJ][HC], ag[HJ][HC];
#pragma unroll
      for (int j = 0; j < HJ; ++j)
#pragma unroll
        for (int c = 0; c < HC; ++c) ap[j][c] = ag[j][c] = 0.f;
      T rp[kLoads], rg[kLoads];
      auto fetch = [&](int k0) {
#pragma unroll
        for (int l = 0; l < kLoads; ++l) {
          const int idx = t + kThreads * l, er = idx / KC, kk = idx % KC;
          const bool ok = e0 + er < E && k0 + kk < E;
          const size_t off = (size_t)(e0 + er) * E + k0 + kk;
          rp[l] = ok ? wp[off] : zero;
          rg[l] = ok ? wg[off] : zero;
        }
      };
      fetch(0);
      for (int s = 0; s < slices; ++s) {
        const int k0 = s * KC;
#pragma unroll
        for (int l = 0; l < kLoads; ++l) {
          const int idx = t + kThreads * l;
          ws[0][idx / KC][idx % KC] = to_f(rp[l]);
          ws[1][idx / KC][idx % KC] = to_f(rg[l]);
        }
        __syncthreads();
        if (s + 1 < slices) fetch(k0 + KC);
        const int kn = min(KC, E - k0);
        for (int kk = 0; kk < kn; ++kk) {
          float pv[HJ];
#pragma unroll
          for (int j = 0; j < HJ; ++j) {
            const int w = w0 + wl + 8 * j;
            pv[j] = w < nw ? pooled[w * E + k0 + kk] : 0.f;
          }
#pragma unroll
          for (int c = 0; c < HC; ++c) {
            const float vp = ws[0][lane + 32 * c][kk], vg = ws[1][lane + 32 * c][kk];
#pragma unroll
            for (int j = 0; j < HJ; ++j) {
              ap[j][c] = fmaf(pv[j], vp, ap[j][c]);
              ag[j][c] = fmaf(pv[j], vg, ag[j][c]);
            }
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int c = 0; c < HC; ++c) {
        const int e = e0 + lane + 32 * c;
        if (e >= E) continue;
        const float bpe = to_f(bp[e]), bge = to_f(bg[e]);
#pragma unroll
        for (int j = 0; j < HJ; ++j) {
          const int w = w0 + wl + 8 * j;
          if (w < nw) {
            const float gate = sigmoidf(ag[j][c] + bge);
            const float pv = pooled[w * E + e];
            out[(size_t)(n0 + w) * E + e] =
                from_f<T>(gate * (ap[j][c] + bpe) + (1.f - gate) * pv);
          }
        }
      }
    }
  }
}

// Windows per block: one wave of blocks over the SMs, each block's pooled
// rows within shared memory.
inline int windows_per_block(int N, int E, int n_sm, size_t tile_bytes) {
  const long long tn = (N + n_sm - 1) / n_sm;
  const long long fit = (long long)(kMaxSmem - tile_bytes) / (4LL * E);
  return (int)(tn < fit ? tn : fit);
}

template <typename T, int EN>
int launch_tiles(const void* x, const void* kcat, const void* cb, const void* wp,
                 const void* bp, const void* wg, const void* bg, void* out, int N, int F,
                 int D, int E, cudaStream_t st) {
  int dev = 0, n_sm = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  const int tn = windows_per_block(N, E, n_sm, Tile<T, EN>::kBytes);
  if (tn < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = Tile<T, EN>::kBytes + (size_t)tn * E * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(window_embed_kernel<T, EN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + tn - 1) / tn;
  window_embed_kernel<T, EN><<<blocks, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(kcat), static_cast<const T*>(cb),
      static_cast<const T*>(wp), static_cast<const T*>(bp), static_cast<const T*>(wg),
      static_cast<const T*>(bg), static_cast<T*>(out), N, F, D, E, tn);
  return (int)cudaGetLastError();
}

// The fp32 tile width (96, 128 or 160 channels) that pads E least; ties go
// to the wider tile.
inline int fp32_tile_channels(int E) {
  int best = 160;
  for (int en : {128, 96}) {
    if ((E + en - 1) / en * en < (E + best - 1) / best * best) best = en;
  }
  return best;
}

template <typename T>
int launch(const void* x, const void* kcat, const void* cb, const void* wp, const void* bp,
           const void* wg, const void* bg, void* out, int N, int F, int D, int E,
           cudaStream_t st) {
  if (F < 2 || N < 1 || D < 1 || E < 1) return (int)cudaErrorInvalidValue;
  if constexpr (std::is_same<T, float>::value) {
    switch (fp32_tile_channels(E)) {
      case 96:
        return launch_tiles<T, 96>(x, kcat, cb, wp, bp, wg, bg, out, N, F, D, E, st);
      case 160:
        return launch_tiles<T, 160>(x, kcat, cb, wp, bp, wg, bg, out, N, F, D, E, st);
    }
  }
  return launch_tiles<T, 128>(x, kcat, cb, wp, bp, wg, bg, out, N, F, D, E, st);
}

}  // namespace wembed
}  // namespace mmtx

// kcat: the conv weight as [E, 2D] = [W0 | W1] (the wrapper lays it out).
extern "C" int mmtx_window_embed(int dtype, const void* x, const void* kcat,
                                 const void* conv_b, const void* wp, const void* bp,
                                 const void* wg, const void* bg, void* out, int N,
                                 int F, int D, int E, void* stream) {
  using namespace mmtx;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return wembed::launch<float>(x, kcat, conv_b, wp, bp, wg, bg, out, N, F, D, E, st);
  if (dtype == kBF16)
    return wembed::launch<__nv_bfloat16>(x, kcat, conv_b, wp, bp, wg, bg, out, N, F, D,
                                         E, st);
  return (int)cudaErrorInvalidValue;
}
