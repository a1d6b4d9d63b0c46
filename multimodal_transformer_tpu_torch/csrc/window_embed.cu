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
// Two routes, chosen by the wrapper from (dtype, F, D, E, alignment)
// alone, before the launch (the wgmma route's shape test is plan() below,
// which the wrapper asks through mmtx_window_embed_tiled_plan), each with
// its own C entry; neither stands in for the other.
//
// The wgmma route (namespace wembed_tc, mmtx_window_embed_tiled): bf16 with
// F - 1 <= 64, D % 4 == 0, E % 4 == 0, E <= 320 and x, Wp, Wg 8-byte
// aligned (every front end of every family but B1's ReLU Highway).
//   * Rows.  A window gets R rows of the conv's M dimension, R the power of
//     two >= F - 1, so a 128-row M tile holds 128 / R whole windows (4
//     linguistic, 32 image or acoustic).  Rows f >= F - 1 are set to -inf
//     before the max.  One block an SM, its windows a contiguous share of
//     N as even as windows allow (the highway's work follows the windows),
//     in tiles from its first window.
//   * A: each frame staged once.  A tile's frames are a contiguous
//     [128 / R * F, D] block of x.  The producer warpgroup copies its k
//     slices of 32 values into a ring of stages with cp.async (8 bytes; 16
//     where D % 8 == 0: a 600-byte linguistic row is no 16-byte multiple,
//     so TMA cannot take it), each thread arriving on the stage's mbarrier,
//     rows 80 bytes apart (ldmatrix rows 16-byte aligned and free of bank
//     conflicts), zeros past D and past the block's last window.  Each
//     tile is first asked of L2 in one bulk prefetch a tile ahead: read 64
//     bytes a row at a time, the frames came from device memory at a
//     fraction of its rate, and one warp's copies held a stage to ~2 us.
//     Row (w, f) reads frame w F + f for W0 and the next frame for W1
//     through ldmatrix at its own address: the pair is a shifted address,
//     not a second copy, and rows f >= F - 1 read frame F - 2.
//   * B: the wrapper lays the conv weight out once a call as [2, E_pad,
//     D_pad] bf16, zero-padded (E_pad = 32, 64, 96, 256 or 320); each stage
//     brings the W0 and W1 slices of its k range by TMA (64-byte swizzle,
//     K-major), so one A stage feeds both halves.
//   * The product.  Every channel in one pass (E = 300 as 128 + 128 + 64,
//     256 as 2 x 128, 88 as 64 + 32), so frames are never read again per
//     channel tile: two consumer warpgroups of 64 rows x E_pad channels
//     (at most 160 fp32 accumulators a thread; setmaxnreg gives them the
//     producer warpgroup's registers: a kernel with wgmma is given
//     registers as if its block were whole warpgroups), wgmma m64nNk16
//     with A from registers.
//   * The max over frames in registers, 32 columns at a time.  A window's
//     R rows lie in a thread's rows g and g + 8 and across the lanes that
//     differ in g (lane = 4 g + t): a reduce-scatter over lane bits 2-4
//     (each step sends half the values and keeps the other half); windows
//     over 16 rows join their warps' maxima through a small shared-memory
//     exchange.  The bias is added after the max (fp32 rounding of c + b
//     is monotone in c, so the result is the same), and the pooled rows
//     stay in shared memory in fp32.
//   * The highway on the FMA pipes in fp32 over the pooled rows of the
//     block's tiles (a group of them where they do not all fit), its bf16
//     weights streamed by cp.async through the ring's bytes while the
//     producer waits.
//   What bounds it (H100, B=32, T=160, phase stamps per block): the conv
//   loop is held by its loads (every 128-row tile reads the whole conv
//   weight from L2: ~58 of ~111 us at image, ~140 of ~220 at linguistic,
//   pooling ~2 us a tile of it); the highway then runs at about half the
//   FMA pipes' rate (~52 and ~77 us).
//
// The tiles route (namespace wembed, mmtx_window_embed): fp32, and bf16
// outside the wgmma route's conditions (e.g. F - 1 > 64, D % 4 != 0).
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
//     when D is a multiple of 4, value by value otherwise.

#include <algorithm>
#include <initializer_list>
#include <iterator>
#include <type_traits>

#include "hopper.cuh"

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
        if constexpr (EN == 160) {
          // one running offset: with an address kept per value, the fp32
          // tile of 160 channels passes 255 registers and spills.  The
          // narrower tiles keep those addresses: with the running offset
          // the fp32 96- and 128-channel tiles took 3.7% and 6.5% longer at
          // the MFT acoustic and image front ends (H100, B=32, T=160)
          constexpr int kRows = kThreads / KC;
          const int er0 = e0 + t / KC, kk0 = t % KC;
          const bool kin = k0 + kk0 < E;
          int off = er0 * E + k0 + kk0;
#pragma unroll
          for (int l = 0; l < kLoads; ++l, off += kRows * E) {
            const bool ok = kin && er0 + kRows * l < E;
            rp[l] = ok ? wp[off] : zero;
            rg[l] = ok ? wg[off] : zero;
          }
        } else {
#pragma unroll
          for (int l = 0; l < kLoads; ++l) {
            const int idx = t + kThreads * l, er = idx / KC, kk = idx % KC;
            const bool ok = e0 + er < E && k0 + kk < E;
            const size_t off = (size_t)(e0 + er) * E + k0 + kk;
            rp[l] = ok ? wp[off] : zero;
            rg[l] = ok ? wg[off] : zero;
          }
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

// ---------------------------------------------------------------------------
// bf16 at the front ends' widths: each frame staged once, the conv on wgmma
// over every channel, the max over frames in registers (see the top).

namespace mmtx {
namespace wembed_tc {

using namespace ::mmtx::sm90;
using bf16 = __nv_bfloat16;

constexpr int kConsumers = 2;                     // warpgroups of 64 rows
constexpr int kThreads = 128 * (1 + kConsumers);  // warpgroup 0 produces
// 128 * 40 + 256 * 232 = 384 * 168, the registers of the block at entry
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int BM = 64 * kConsumers;      // rows of an M tile
constexpr int BK = 32;                   // k depth of a stage, each half
constexpr int kPitch = 80;               // bytes of a frame row in a stage: 64 + 16
constexpr int kBRow = BK * 2;            // bytes of a weight row in a stage: the swizzle span
constexpr int kGroupBytes = 8 * kBRow;   // 8 weight rows: the descriptors' stride
constexpr uint64_t kSwizzle64 = 2;       // descriptor mode: 64B
constexpr int KCH = 16;                  // highway k depth per weight slice
constexpr int kHwPitch = 2 * KCH + 8;    // bytes of a weight row in a slice (LDS.64 free of conflicts)
constexpr int kHwBufs = 3;               // highway slices in flight
constexpr int kHwThreads = 128 * kConsumers;
constexpr int kMinStages = 3, kMaxStages = 8;
constexpr int kMaxR = 64;                // rows a window at most: F - 1 <= 64
constexpr int kBarBytes = 8 * (2 * kMaxStages + 2);
constexpr int kMaxSmem = 232448;
// named barriers (id 0 is __syncthreads): both consumer warpgroups, then
// each one's own
constexpr int kBarConsumers = 1, kBarGroup0 = 2;
// the instantiated widths, E_pad = 32 NC channels (at most 160
// accumulators): the front ends' E = 20, 44, 88, 256 and 300
constexpr int kWidths[] = {1, 2, 3, 8, 10};

// A launch's plan (plan() on the host; the wrapper asks it through
// mmtx_window_embed_tiled_plan).
// Shared memory, from a 1024-byte aligned base: the ring of stages (each an
// A tile of FR frame rows x 80 bytes, rounded to 1024, then the W0 and W1
// slices, E_pad rows x 64 bytes each; the highway's weight slices reuse
// these bytes), the cross-warp exchange [8][E_pad] fp32, the bias [E_pad],
// the pooled rows [group * WPT][E_pad] fp32, the barriers (full[kMaxStages],
// empty[kMaxStages], the highway's).
struct Plan {
  int N, F, D, E;
  int R, R_log, WPT, FR;  // rows a window (and its log2), windows a tile, frame rows a tile
  int slices;             // k slices: D_pad / BK
  int wpb, tpb, group;    // windows a block, its tiles, tiles whose pooled rows are held at once
  int stages, a_bytes, stage_bytes;
  int boxes, box_rows;    // TMA boxes of a weight half in a stage
  int scratch_off, bias_off, pooled_off, bar_off, smem;
};

inline int padded_channels(int E) {
  for (int nc : kWidths)
    if (32 * nc >= E) return 32 * nc;
  return 0;
}

inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The plan of (N, F, D, E) on n_sm SMs with at least kMinStages stages, or
// false where the route does not take the shape.
inline bool plan(Plan& p, int N, int F, int D, int E, int n_sm) {
  const int EP = padded_channels(E);
  if (N < 1 || F < 2 || F - 1 > kMaxR || D < 1 || D % 4 != 0 || E < 1 || E % 4 != 0 ||
      EP == 0)
    return false;
  p.N = N;
  p.F = F;
  p.D = D;
  p.E = E;
  p.R_log = 0;
  while ((1 << p.R_log) < F - 1) ++p.R_log;
  p.R = 1 << p.R_log;
  p.WPT = BM / p.R;
  p.FR = p.WPT * F;
  p.slices = (D + BK - 1) / BK;
  p.wpb = (N + n_sm - 1) / n_sm;  // as even as windows allow: the highway's work
  p.tpb = (p.wpb + p.WPT - 1) / p.WPT;
  p.a_bytes = round_up(p.FR * kPitch, 1024);
  p.stage_bytes = p.a_bytes + 2 * EP * kBRow;
  const int highway = kHwBufs * 2 * EP * kHwPitch;
  const int fixed = 8 * EP * 4 + EP * 4 + kBarBytes + 1024;  // + alignment slack
  const int tile_rows = p.WPT * EP * 4;                      // a tile's pooled rows
  const int avail = kMaxSmem - fixed - std::max(kMinStages * p.stage_bytes, highway);
  if (avail < tile_rows) return false;
  p.group = std::min(p.tpb, avail / tile_rows);
  p.stages = std::min(kMaxStages, (kMaxSmem - fixed - p.group * tile_rows) / p.stage_bytes);
  p.boxes = (EP + 255) / 256;
  p.box_rows = EP / p.boxes;
  p.scratch_off = std::max(p.stages * p.stage_bytes, highway);
  p.bias_off = p.scratch_off + 8 * EP * 4;
  p.pooled_off = p.bias_off + EP * 4;
  p.bar_off = p.pooled_off + p.group * tile_rows;
  p.smem = p.bar_off + kBarBytes + 1024;
  return true;
}

inline int device_sms() {
  int dev = 0, n_sm = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  return n_sm;
}

struct Args {
  const bf16* x;   // [N, F, D]
  const bf16* cb;  // the conv bias [E]
  const bf16* wp;  // the highway's projection [E, E] and bias
  const bf16* bp;
  const bf16* wg;  // the gate [E, E] and bias
  const bf16* bg;
  bf16* out;       // [N, E]
  Plan p;
};

// The producer warpgroup (pt its thread): every stage of the block's tiles
// in order, group by group (a group's first stage waits until the highway
// of the one before has left the ring's bytes).  Thread 0 loads the
// stage's W0 and W1 slices by TMA and asks L2 for the next tile's frames;
// every thread copies its share of the tile's frame rows, 16 bytes at a
// time where D % 8 == 0 and x is 16-byte aligned, else 8 (pt % 4 or 8 is
// the piece of the row's 64 bytes), and arrives on the stage's barrier
// when they land (one warp's copies at 8 bytes held the ring to ~2 us a
// stage).
template <int EP>
__device__ __forceinline__ void produce(const CUtensorMap& wmap, const Args& a, uint32_t base,
                                        uint8_t* smem, uint32_t full0, uint32_t empty0,
                                        uint32_t hw_done, int wb0, int wb1, int nt,
                                        int groups, int pt) {
  const Plan& p = a.p;
  const size_t rows = (size_t)wb1 * p.F;  // past the block's last window: zeros
  // 16-byte copies where every row piece is 16-byte aligned, else 8
  const bool wide = p.D % 8 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  const int q = wide ? pt & 3 : pt & 7, r_step = wide ? 128 / 4 : 128 / 8;
  // a tile's frames into L2 in one stream before its k slices read them
  // 64 bytes a row at a time (read so, from device memory, they came at a
  // fraction of its rate)
  auto prefetch = [&](int tt) {
    if (pt != 0 || tt >= nt) return;
    const size_t r0 = (size_t)(wb0 + tt * p.WPT) * p.F;
    const size_t r1 = r0 + p.FR < rows ? r0 + p.FR : rows;
    const uintptr_t lo = (reinterpret_cast<uintptr_t>(a.x + r0 * p.D) + 15) & ~uintptr_t(15);
    const uintptr_t hi = reinterpret_cast<uintptr_t>(a.x + r1 * p.D) & ~uintptr_t(15);
    if (hi > lo) prefetch_l2(reinterpret_cast<const void*>(lo), (uint32_t)(hi - lo));
  };
  prefetch(0);
  int i = 0;
  for (int gi = 0; gi < groups; ++gi) {
    if (gi > 0) mbar_wait(hw_done, (gi - 1) & 1);
    const int end = min(nt, (gi + 1) * p.group);
    for (int tt = gi * p.group; tt < end; ++tt) {
      prefetch(tt + 1);
      const size_t r0 = (size_t)(wb0 + tt * p.WPT) * p.F;  // the tile's first frame row
      for (int s = 0; s < p.slices; ++s, ++i) {
        const int slot = i % p.stages;
        const uint32_t full = full0 + 8 * slot, st = base + slot * p.stage_bytes;
        mbar_wait(empty0 + 8 * slot, ((i / p.stages) & 1) ^ 1);
        if (pt == 0) {
          mbar_arrive_tx(full, 2 * EP * kBRow);
          for (int h = 0; h < 2; ++h)
            for (int b = 0; b < p.boxes; ++b) {
              const int row = h * EP + b * p.box_rows;
              tma_load_2d(st + p.a_bytes + row * kBRow, &wmap, BK * s, row, full);
            }
        }
        uint8_t* dst = smem + (size_t)slot * p.stage_bytes;
        if (wide) {
          const int k = BK * s + 8 * q;
          for (int r = pt >> 2; r < p.FR; r += r_step) {
            const bool ok = k < p.D && r0 + r < rows;
            cp_async<16>(dst + r * kPitch + 16 * q, ok ? a.x + (r0 + r) * p.D + k : a.x, ok);
          }
        } else {
          const int k = BK * s + 4 * q;
          for (int r = pt >> 3; r < p.FR; r += r_step) {
            const bool ok = k < p.D && r0 + r < rows;
            cp_async<8>(dst + r * kPitch + 8 * q, ok ? a.x + (r0 + r) * p.D + k : a.x, ok);
          }
        }
        mbar_arrive_cp_async(full);
      }
    }
  }
}

// acc += a . B_half over every channel: B_half's rows (K-major, 64-byte
// swizzle) at b, at the k step; E_pad = 32 NC columns as NC / 4 products of
// 128, then one of 64 and one of 32 where NC asks.  acc[4 J + 2 rr + e] is
// row g + 8 rr (of the warp's 16), column 8 J + 2 t + e: chunk by chunk in
// wgmma's accumulator layout.
template <int NC>
__device__ __forceinline__ void mma_row(float (&acc)[16 * NC], const uint32_t (&a)[4],
                                        uint32_t b) {
  constexpr int N128 = NC / 4, N64 = (NC % 4) / 2, N32 = NC % 2;
#pragma unroll
  for (int q = 0; q < N128; ++q)
    wgmma_n128(reinterpret_cast<float(&)[64]>(acc[64 * q]), a,
               smem_desc(b + 128 * q * kBRow, kGroupBytes, kSwizzle64), 1);
  if constexpr (N64 > 0)
    wgmma_n64(reinterpret_cast<float(&)[32]>(acc[64 * N128]), a,
              smem_desc(b + 128 * N128 * kBRow, kGroupBytes, kSwizzle64), 1);
  if constexpr (N32 > 0)
    wgmma_n32(reinterpret_cast<float(&)[16]>(acc[64 * N128 + 32 * N64]), a,
              smem_desc(b + (128 * N128 + 64 * N64) * kBRow, kGroupBytes, kSwizzle64), 1);
}

// Reduce-scatter of v over S lane bits (mask, 2 mask, ...): at each step a
// lane keeps one half of its values, sends its partner the other and takes
// the max with what the partner sent, so each lane ends with NV >> S values,
// each the max over the 2^S lanes; o[i] is the max at index i + off of v.
template <int NV, int S>
__device__ __forceinline__ void reduce_lanes(const float (&v)[NV], float (&o)[NV >> S], int g,
                                             int mask, int& off) {
  if constexpr (S == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) o[i] = v[i];
  } else {
    float h[NV / 2];
    const bool up = g & 1;
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) {
      const float send = up ? v[i] : v[i + NV / 2];
      const float keep = up ? v[i + NV / 2] : v[i];
      h[i] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, mask));
    }
    off += up ? NV / 2 : 0;
    reduce_lanes<NV / 2, S - 1>(h, o, g >> 1, 2 * mask, off);
  }
}

// put(window, value, max) for each of o's M maxima of rows g (indices < 8)
// and g + 8 (the rest), index i + off; row g's window starts at row lead.
template <int M, typename Put>
__device__ __forceinline__ void emit_rows(const float (&o)[M], int off, int lead, int R_log,
                                          Put put) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const int idx = i + off, rr = idx >= 8;
    put((lead + 8 * rr) >> R_log, idx - 8 * rr, o[i]);
  }
}

// The pooled rows of a tile from its conv accumulators (warpgroup c, warp
// `warp` of it): rows f >= F - 1 to -inf, the max over each window's R
// rows, + bias, to pooled (the tile's [WPT][E_pad] rows).  32 columns at a
// time (a unit u: acc[16 u ..], 8 values of each of the thread's two
// rows), so that few values are live beside the accumulators; value o of
// unit u of a row is column 32 u + 8 (o / 2) + 2 t + o % 2.
template <int NC>
__device__ __forceinline__ void pool_tile(float (&acc)[16 * NC], const Plan& p, float* pooled,
                                          float* scratch, const float* bias, int c, int warp,
                                          int lane, bool dead0, bool dead1) {
  constexpr int EP = 32 * NC;
  const int g = lane >> 2, t = lane & 3, R = p.R;
  const int row0 = 64 * c + 16 * warp;  // the warp's first row in the tile
#pragma unroll
  for (int J = 0; J < 4 * NC; ++J) {
    if (dead0) acc[4 * J] = acc[4 * J + 1] = -INFINITY;
    if (dead1) acc[4 * J + 2] = acc[4 * J + 3] = -INFINITY;
  }
  auto col = [&](int u, int o) { return 32 * u + 8 * (o >> 1) + 2 * t + (o & 1); };
  if (R < 16) {  // a window within rows g or within rows g + 8
    const int lead = row0 + (g & ~(R - 1));  // row g's window starts here
#pragma unroll
    for (int u = 0; u < NC; ++u) {
      auto put = [&](int win, int o, float v) {
        const int cc = col(u, o);
        pooled[win * EP + cc] = v + bias[cc];
      };
      float v[16];  // row g's 8 values of the unit, then row g + 8's
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[2 * j + e] = acc[16 * u + 4 * j + e];
          v[8 + 2 * j + e] = acc[16 * u + 4 * j + 2 + e];
        }
      int off = 0;
      if (R == 1) {
        emit_rows<16>(v, 0, lead, p.R_log, put);
      } else if (R == 2) {
        float o[8];
        reduce_lanes<16, 1>(v, o, g, 4, off);
        emit_rows<8>(o, off, lead, p.R_log, put);
      } else if (R == 4) {
        float o[4];
        reduce_lanes<16, 2>(v, o, g, 4, off);
        emit_rows<4>(o, off, lead, p.R_log, put);
      } else {
        float o[2];
        reduce_lanes<16, 3>(v, o, g, 4, off);
        emit_rows<2>(o, off, lead, p.R_log, put);
      }
    }
    return;
  }
  // rows g and g + 8 lie in one window: one max a unit and lane
  float m[NC];
  int off = 0;
#pragma unroll
  for (int u = 0; u < NC; ++u) {
    float v[8], o[1];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        v[2 * j + e] = fmaxf(acc[16 * u + 4 * j + e], acc[16 * u + 4 * j + 2 + e]);
    off = 0;
    reduce_lanes<8, 3>(v, o, g, 4, off);
    m[u] = o[0];
  }
  if (R == 16) {
#pragma unroll
    for (int u = 0; u < NC; ++u) pooled[(row0 / 16) * EP + col(u, off)] = m[u] + bias[col(u, off)];
    return;
  }
  // R / 16 warps a window: each warp's maxima through the exchange
  float* mine = scratch + (4 * c + warp) * EP;
#pragma unroll
  for (int u = 0; u < NC; ++u) mine[col(u, off)] = m[u];
  bar_sync(kBarGroup0 + c, 128);
  const int per = R >> 4;
  for (int idx = threadIdx.x % 128; idx < (64 >> p.R_log) * EP; idx += 128) {
    const int w = idx / EP, cc = idx % EP;
    float mx = -INFINITY;
    for (int k = 0; k < per; ++k) mx = fmaxf(mx, scratch[(4 * c + w * per + k) * EP + cc]);
    pooled[(((64 * c) >> p.R_log) + w) * EP + cc] = mx + bias[cc];
  }
  bar_sync(kBarGroup0 + c, 128);
}

// The highway of nw pooled rows (windows n0 ..) on the FMA pipes in fp32,
// by the 256 consumer threads (ht): warp wl owns windows w0 + wl + 8 j (j <
// HJ = 5: 40 a pass, at least the ~39 a block of every front end at B=32,
// T=160), lane owns channels lane + 32 c (c < NC).  The bf16 weights stream
// through a ring of kHwBufs slices in shared memory (ws, the ring's bytes;
// [proj | gate][E_pad rows of kHwPitch bytes][KCH k]) by 8-byte cp.async,
// two slices ahead, one barrier a slice, zeros past E.  Four k steps a
// read: a float4 of each window's pooled row (one address for the warp)
// and 4 bf16 of each channel's weight row, widened in registers (widening
// each slice once in shared memory instead cost a second barrier a slice
// and was slower on an H100).
template <int NC>
__device__ __forceinline__ void highway(const Args& a, const float* pooled, uint8_t* ws, int n0,
                                        int nw, int ht) {
  constexpr int EP = 32 * NC, HJ = 5, kBuf = 2 * EP * kHwPitch;
  const int E = a.p.E, lane = ht & 31, wl = ht >> 5;
  const int slices = (E + KCH - 1) / KCH;
  // slice s into buffer b: 8 bytes (4 k) at a time, 2 EP rows x KCH / 4
  auto issue = [&](int s, int b) {
    if (s < slices) {
      const int k0 = s * KCH;
      for (int i = ht; i < 2 * EP * (KCH / 4); i += kHwThreads) {
        const int m = i / (EP * (KCH / 4)), rem = i % (EP * (KCH / 4));
        const int er = rem / (KCH / 4), j = rem % (KCH / 4), k = k0 + 4 * j;
        const bool ok = er < E && k < E;
        const bf16* w = m == 0 ? a.wp : a.wg;
        cp_async<8>(ws + b * kBuf + (m * EP + er) * kHwPitch + 8 * j,
                    ok ? w + (size_t)er * E + k : w, ok);
      }
    }
    cp_async_commit();
  };
  auto widen = [](uint32_t u, float& lo, float& hi) {
    lo = __uint_as_float(u << 16);
    hi = __uint_as_float(u & 0xffff0000u);
  };
  for (int w0 = 0; w0 < nw; w0 += 8 * HJ) {
    float ap[HJ][NC], ag[HJ][NC];
#pragma unroll
    for (int j = 0; j < HJ; ++j)
#pragma unroll
      for (int c = 0; c < NC; ++c) ap[j][c] = ag[j][c] = 0.f;
    issue(0, 0);
    issue(1, 1);
    for (int s = 0; s < slices; ++s) {
      cp_async_wait<1>();                   // this thread's copies of slice s
      bar_sync(kBarConsumers, kHwThreads);  // everyone's; slice s - 1 read
      issue(s + 2, (s + 2) % kHwBufs);
      const uint8_t* buf = ws + (s % kHwBufs) * kBuf;
      const int k0 = s * KCH;
#pragma unroll
      for (int q = 0; q < KCH / 4; ++q) {
        float4 pv[HJ];
#pragma unroll
        for (int j = 0; j < HJ; ++j) {
          const int w = w0 + wl + 8 * j;
          pv[j] = w < nw ? *reinterpret_cast<const float4*>(pooled + w * EP + k0 + 4 * q)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const uint2 up = *reinterpret_cast<const uint2*>(
              buf + (lane + 32 * c) * kHwPitch + 8 * q);
          const uint2 ug = *reinterpret_cast<const uint2*>(
              buf + (EP + lane + 32 * c) * kHwPitch + 8 * q);
          float p0, p1, p2, p3, g0, g1, g2, g3;
          widen(up.x, p0, p1);
          widen(up.y, p2, p3);
          widen(ug.x, g0, g1);
          widen(ug.y, g2, g3);
#pragma unroll
          for (int j = 0; j < HJ; ++j) {
            ap[j][c] = fmaf(pv[j].x, p0, ap[j][c]);
            ag[j][c] = fmaf(pv[j].x, g0, ag[j][c]);
            ap[j][c] = fmaf(pv[j].y, p1, ap[j][c]);
            ag[j][c] = fmaf(pv[j].y, g1, ag[j][c]);
            ap[j][c] = fmaf(pv[j].z, p2, ap[j][c]);
            ag[j][c] = fmaf(pv[j].z, g2, ag[j][c]);
            ap[j][c] = fmaf(pv[j].w, p3, ap[j][c]);
            ag[j][c] = fmaf(pv[j].w, g3, ag[j][c]);
          }
        }
      }
    }
    cp_async_wait<0>();
    bar_sync(kBarConsumers, kHwThreads);  // the ring is free for the next pass
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int e = lane + 32 * c;
      if (e >= E) continue;
      const float bpe = __bfloat162float(a.bp[e]), bge = __bfloat162float(a.bg[e]);
#pragma unroll
      for (int j = 0; j < HJ; ++j) {
        const int w = w0 + wl + 8 * j;
        if (w < nw) {
          const float gate = sigmoidf(ag[j][c] + bge);
          a.out[(size_t)(n0 + w) * E + e] = __float2bfloat16_rn(
              gate * (ap[j][c] + bpe) + (1.f - gate) * pooled[w * EP + e]);
        }
      }
    }
  }
}

// One block: its windows [wb0, wb1) (N split as evenly as windows allow,
// for the highway's sake) in tiles of WPT windows from wb0, the last tile's
// rows past wb1 zeros, in groups of p.group tiles (the pooled rows a group
// leaves in shared memory), the highway after each group.
// Warpgroup 0 produces the ring; warpgroups 1 and 2 take 64 rows of each
// tile each: per stage, their A fragments by ldmatrix (rows at
// their own frame addresses, W1's a frame on), every channel's product on
// wgmma, the stage freed once those have completed; per tile, the max over
// frames into the pooled rows.
template <int NC>
__global__ void __launch_bounds__(kThreads, 1)
window_embed_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                          const __grid_constant__ Args a) {
  constexpr int EP = 32 * NC;
  const Plan& p = a.p;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  float* scratch = reinterpret_cast<float*>(smem + p.scratch_off);
  float* bias = reinterpret_cast<float*>(smem + p.bias_off);
  float* pooled = reinterpret_cast<float*>(smem + p.pooled_off);
  const uint32_t full0 = base + p.bar_off, empty0 = full0 + 8 * kMaxStages;
  const uint32_t hw_done = empty0 + 8 * kMaxStages;
  const int wb0 = blockIdx.x * p.wpb, wb1 = min(p.N, wb0 + p.wpb);  // the block's windows
  const int nt = (wb1 - wb0 + p.WPT - 1) / p.WPT;
  const int groups = (nt + p.group - 1) / p.group;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full0 + 8 * s, 129);              // the TMA's bytes, 128 threads' copies
      mbar_init(empty0 + 8 * s, 4 * kConsumers);  // every consumer warp
    }
    mbar_init(hw_done, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_proxy_async();
  }
  for (int i = threadIdx.x; i < EP; i += kThreads)
    bias[i] = i < p.E ? __bfloat162float(a.cb[i]) : 0.f;
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    produce<EP>(wmap, a, base, smem, full0, empty0, hw_done, wb0, wb1, nt, groups,
                threadIdx.x);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
  const int c = wg - 1, R = p.R, F = p.F;
  // the row this lane gives ldmatrix the address of, and its frame row in a
  // stage (W0's; W1 reads the next); rows f >= F - 1 read frame F - 2
  const int lr = 64 * c + 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
  const uint32_t a_off =
      ((lr >> p.R_log) * F + min(lr & (R - 1), F - 2)) * kPitch + 16 * (lane >> 4);
  // the thread's accumulator rows, g and g + 8 of its warp's: past F - 1?
  const int r0 = 64 * c + 16 * warp + (lane >> 2);
  const bool dead0 = (r0 & (R - 1)) >= F - 1, dead1 = ((r0 + 8) & (R - 1)) >= F - 1;
  int i = 0;
  for (int gi = 0; gi < groups; ++gi) {
    const int tg = gi * p.group, end = min(nt, tg + p.group);
    for (int tt = tg; tt < end; ++tt) {
      float acc[16 * NC];
#pragma unroll
      for (int j = 0; j < 16 * NC; ++j) acc[j] = 0.f;
      for (int s = 0; s < p.slices; ++s, ++i) {
        const int slot = i % p.stages;
        mbar_wait(full0 + 8 * slot, (i / p.stages) & 1);
        const uint32_t st = base + slot * p.stage_bytes;
        uint32_t af[2][2][4];  // [k step][W0 | W1]
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int h = 0; h < 2; ++h) ldmatrix_x4(af[ks][h], st + a_off + h * kPitch + 32 * ks);
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            mma_row<NC>(acc, af[ks][h], st + p.a_bytes + h * EP * kBRow + 32 * ks);
        wg_commit();
        wg_wait<0>();
        fence_regs(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * slot);
      }
      pool_tile<NC>(acc, p, pooled + (tt - tg) * p.WPT * EP, scratch, bias, c, warp, lane,
                    dead0, dead1);
    }
    bar_sync(kBarConsumers, kHwThreads);  // every pooled row, every stage consumed
    const int n0 = wb0 + tg * p.WPT;
    highway<NC>(a, pooled, smem, n0,
                min((end - tg) * p.WPT, wb1 - n0), threadIdx.x - 128);
    if (gi + 1 < groups) {  // hand the ring's bytes back to the producer
      fence_proxy_async();
      bar_sync(kBarConsumers, kHwThreads);
      if (threadIdx.x == 128) mbar_arrive(hw_done);
    }
  }
}

// The TMA map of the laid-out weight [2 E_pad, D_pad] bf16: boxes of 32
// columns x box_rows rows, 64-byte swizzle.
inline bool weight_map(CUtensorMap* map, const void* wt, int rows, int cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(wt), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NC>
int launch(const Plan& p, const void* x, const void* wt, const void* cb, const void* wp,
           const void* bp, const void* wg, const void* bg, void* out, cudaStream_t st) {
  const auto kernel = window_embed_wgmma_kernel<NC>;
  static int setup = -1;  // cudaError_t of the one-time set-up
  if (setup < 0) {
    cudaFuncAttributes attr;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    // setmaxnreg.inc waits for registers the producer released: the block
    // must start with all of them, or the consumers would wait forever
    if (err == cudaSuccess &&
        attr.numRegs * kThreads < 128 * (kProducerRegs + kConsumers * kConsumerRegs))
      err = cudaErrorInvalidConfiguration;
    setup = (int)err;
  }
  if (setup != 0) return setup;
  CUtensorMap map;
  if (!weight_map(&map, wt, 64 * NC, round_up(p.D, BK), p.box_rows))
    return (int)cudaErrorInvalidValue;
  const Args args{static_cast<const bf16*>(x),  static_cast<const bf16*>(cb),
                  static_cast<const bf16*>(wp), static_cast<const bf16*>(bp),
                  static_cast<const bf16*>(wg), static_cast<const bf16*>(bg),
                  static_cast<bf16*>(out),      p};
  kernel<<<(p.N + p.wpb - 1) / p.wpb, kThreads, p.smem, st>>>(map, args);
  return (int)cudaGetLastError();
}

}  // namespace wembed_tc
}  // namespace mmtx

// The wgmma route's plan of N windows of F frames, D values, E channels on
// the current device: 1 where the route takes the shape (the wrapper's
// route() asks), else 0.  Where out is not null it receives {R, E_pad,
// D_pad, tiles a block, tiles whose pooled rows are held at once, stages,
// shared-memory bytes}.
extern "C" int mmtx_window_embed_tiled_plan(int N, int F, int D, int E, int* out) {
  using namespace mmtx::wembed_tc;
  Plan p;
  if (!plan(p, N, F, D, E, device_sms())) return 0;
  if (out) {
    const int v[] = {p.R, padded_channels(E), round_up(D, BK), p.tpb, p.group, p.stages,
                     p.smem};
    std::copy(std::begin(v), std::end(v), out);
  }
  return 1;
}

// The wgmma route (bf16).  x [N, F, D] 8-byte aligned; wt the conv weight
// laid out as [2, E_pad, D_pad] (W0 then W1, zero-padded; the wrapper's
// tiled_weight), E_pad and D_pad as the wrapper computed them, which must
// be this route's for (D, E); the rest as mmtx_window_embed.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a shape
// the route does not take.
extern "C" int mmtx_window_embed_tiled(const void* x, const void* wt, const void* conv_b,
                                       const void* wp, const void* bp, const void* wg,
                                       const void* bg, void* out, int N, int F, int D, int E,
                                       int E_pad, int D_pad, void* stream) {
  using namespace mmtx::wembed_tc;
  Plan p;
  if (!plan(p, N, F, D, E, device_sms()) || E_pad != padded_channels(E) ||
      D_pad != round_up(D, BK) || reinterpret_cast<uintptr_t>(x) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(wp) % 8 != 0 || reinterpret_cast<uintptr_t>(wg) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (E_pad / 32) {
    case 1: return launch<1>(p, x, wt, conv_b, wp, bp, wg, bg, out, st);
    case 2: return launch<2>(p, x, wt, conv_b, wp, bp, wg, bg, out, st);
    case 3: return launch<3>(p, x, wt, conv_b, wp, bp, wg, bg, out, st);
    case 8: return launch<8>(p, x, wt, conv_b, wp, bp, wg, bg, out, st);
    case 10: return launch<10>(p, x, wt, conv_b, wp, bp, wg, bg, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
