// Kernels 4 and 5 on Hopper: one encoder layer's training backward (and the
// whole stack's, layer by layer) in bf16 with every product on wgmma.
//
// Replaces, for bf16 at d_k in {16, 32}, D in {128, 256} and F = 128:
// multimodal_transformer_tpu/ops/pallas/encoder.py _layer_bwd_call (kernel
// 4) and _stack_bwd_call (kernel 5), body _layer_bwd_core.  The C entries
// in encoder_train.cu send those shapes here; fp32 and other widths stay on
// encoder_train.cu's FMA code.
//
// The function is kernel 4's: from a layer's saved fp32 input x and the
// gradient dy of its output, recompute the layer (LN1, q k v, attention
// with its dropout, the out projection with its dropout and residual x1,
// LN2, FFN1) and emit dx and the 16 fp32 parameter gradients.  Rounding
// points are the TPU kernel's: every product takes bf16 operands and sums
// in fp32; dff, dmidp and dattn are rounded before their products (their
// bias gradients sum the fp32 values), do is stored in bf16, dv takes the
// rounded dropped probabilities, dq takes ds / sqrt(d_k) rounded and dk ds
// rounded, and dq, dk, dv are stored in bf16 (their bias gradients sum
// those).  Dropout bits are the fmix32 keep bits at the JAX positions, or
// on the "hash4" stream common.cuh hash4_keep's at the (row, column).
//
// Eight launches a layer, in order:
//   1. front: LN1 of 64 rows rounded into wgmma A fragments, then q | k | v
//      as one N = 3D product (q scaled by 1/sqrt(d_k) before its round);
//      stores xn1, qkv and LN1's row mean and variance.
//   2. attention forward, one block per (64 queries, head, video): key
//      tiles of 64 through TMA into a two-slot ring, S = q k^T and the
//      dropped p v on wgmma, an online softmax whose sum takes every p;
//      stores the attention output o and each row's max and sum.
//   3. middle chain, 64 rows a block: the out projection + site-1 dropout
//      + residual (x1, kept in shared memory in fp32), LN2 into fragments,
//      FFN1 (midp stays in registers: the ReLU's mask and the dropped
//      hidden, stored for dW2), dff = site-3 dropout of dy, dmid = dff W2,
//      dmidp, dxn2 = dmidp W1 (twice, the same bits: once for LN2's
//      backward's row sums, once for its outputs, so that dxn2 never stays
//      whole in registers), dx1 = dy + LN2'(dxn2), dattn = site-1 dropout
//      of dx1, do = dattn Wo.  Stores the bf16 operands of the weight
//      gradients, do and dx1, and the block's column sums of the five fp32
//      bias / LN gradients.
//   4. attention dq, one block per (64 queries, head, video): two sweeps
//      over key tiles rebuild P from each row's max and sum, and dP = do
//      v^T, on wgmma; the first sums D_i = sum P dP / sum P (dividing by the
//      rebuilt probabilities' sum keeps the k-bias gradient, whose exact
//      value is 0, at rounding level), the second multiplies dq +=
//      round(ds / sqrt(d_k)) k with ds = P (dP - D_i), 0 at a masked key
//      (its score is the constant -1e9, so autograd's gradient there is 0;
//      only a video with no key has probabilities there that are not ~0).
//   5. attention dk, dv, one block per (64 keys, head, video) over query
//      tiles: S^T and dP^T on wgmma, dv += round(P_dropped) do and dk +=
//      round(ds) q.  No atomics: query tiles own dq, key tiles dk and dv.
//   6. back chain, 64 rows a block: dxn1 = [dq | dk | dv] [Wq; Wk; Wv] (one
//      K = 3D product, the dqkv tile in shared memory), LN1's backward,
//      dx = dx1 + LN1'(dxn1); column sums of dln1a, dln1b and the q, k, v
//      bias gradients.
//   7. weight gradients: dW = G^T X for the six matrices, both operands
//      read MN-major from shared memory (wgmma's transpose bits), over
//      fixed chunks of 1,024 rows; each block writes its chunk's fp32
//      partial of one 64 x 64 tile.
//   8. sums: each weight gradient adds its chunks' partials, each bias /
//      LN gradient its row blocks' column sums, in order, compensated.
// Weights stream through a ring of three 32 KB slots by TMA: a piece is 64
// output columns, read K-major (torch's [N, K] as y = x W^T, boxes of 64 x
// 64) or MN-major (W [K, N] as y = g W, one box of 64 columns x K rows,
// wgmma's transpose bit), so every operand is one 128-byte swizzle row
// wide.  Every sum runs in a fixed order: the same inputs give the same
// bits, and kernel 5, which runs this sequence for every layer, last first,
// gives kernel 4's bits layer by layer.
//
// What bounds it on the H100: at B=32, T=160, D=256, h=8, F=128 a layer is
// ~10 GFLOP of bf16 products (0.0127 ms at 989 TFLOP/s) and ~25 MB of
// operands and outputs; at 80 row blocks the chains are latency in one
// warpgroup each, and the launches wait for one another.

#include "encoder_bwd.cuh"
#include "encoder_train_fwd.cuh"
#include "gemm.cuh"
#include "rows.cuh"

namespace mmtx {
namespace enc_bwd {

using namespace ::mmtx::wg;

constexpr int kPieceBytes = 32768;  // a weight piece: 64 output columns x K <= 256
constexpr int kSlots = 3;           // the ring of pieces
constexpr int kRingBytes = kSlots * kPieceBytes;
constexpr int kBox = BM * 128;      // 64 rows x 128 bytes: one swizzled box
constexpr uint64_t kSw128 = 1;      // descriptor mode: 128B
constexpr float kMaskedScore = -1e9f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSmem = 232448;    // 227 KB, a block's dynamic maximum
constexpr int kChunkRows = 1024;    // rows of one weight-gradient partial
constexpr int kStages = 4;          // the weight-gradient product's cp.async stages
constexpr int kF = 128;             // the FFN width the path takes

enum P : int { LN1A, LN1B, WQ, BQ, WK, BK, WV, BV, WO, BO, LN2A, LN2B, W1, B1, W2, B2 };

// ------------------------------------------------------------- the ring

// A weight piece: 64 output columns from n0 over K rows of the product.
// K-major: K / 64 boxes of 64 columns x 64 rows of W [N, K]; MN-major: one
// box of the 64 columns n0.. x all K rows of W [K, N].
struct Piece {
  const CUtensorMap* map;
  int n0, K;
  bool mn;
};

__device__ __forceinline__ void load_piece(const Piece& pc, uint32_t slot, uint32_t bar) {
  mbar_arrive_tx(bar, 128 * pc.K);
  if (pc.mn) {
    tma_load_2d(slot, pc.map, pc.n0, 0, bar);
  } else {
    for (int c = 0; c < pc.K / 64; ++c) tma_load_2d(slot + c * kBox, pc.map, 64 * c, pc.n0, bar);
  }
}

// The pieces of a chain in the order it multiplies them: thread 0 keeps
// kSlots in flight; ready() waits for the current one, release() frees its
// slot (every thread past its product) and loads the piece kSlots on.
template <typename Fn>
struct Ring {
  uint32_t slots, bars;
  int n, issued, cur;
  Fn fn;
  __device__ Ring(uint32_t s, uint32_t b, int count, Fn f)
      : slots(s), bars(b), n(count), issued(0), cur(0), fn(f) {}
  __device__ void init() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kSlots; ++s) mbar_init(bars + 8 * s, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  __device__ void issue() {
    if (threadIdx.x == 0 && issued < n)
      load_piece(fn(issued), slots + (issued % kSlots) * kPieceBytes,
                 bars + 8 * (issued % kSlots));
    ++issued;
  }
  __device__ void start() {
    for (int s = 0; s < kSlots; ++s) issue();
  }
  __device__ uint32_t ready() const {
    mbar_wait(bars + 8 * (cur % kSlots), (cur / kSlots) & 1);
    return slots + (cur % kSlots) * kPieceBytes;
  }
  __device__ void release() {
    __syncthreads();
    ++cur;
    issue();
  }
};

// Descriptors of k step ks (16 rows of the product's K): a K-major tile of
// 64-column boxes, or an MN-major one of 128-byte rows (8 rows a group).
__device__ __forceinline__ uint64_t kdesc(uint32_t tile, int ks) {
  return smem_desc(tile + (ks / 4) * kBox + (ks % 4) * 32, 1024, kSw128);
}
__device__ __forceinline__ uint64_t mdesc(uint32_t tile, int ks) {
  return smem_desc(tile + ks * 2048, 1024, kSw128);
}

// acc = a . piece over KS k steps, A from registers (RS).
template <int KS, bool MN>
__device__ __forceinline__ void mma_rs(float (&acc)[32], const uint32_t (&a)[KS][4],
                                       uint32_t piece) {
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    if constexpr (MN)
      wgmma_n64_t(acc, a[ks], mdesc(piece, ks), ks);
    else
      wgmma_n64(acc, a[ks], kdesc(piece, ks), ks);
  }
  wg_commit();
  wg_wait<0>();
  fence_regs(acc);
}

// acc (+)= A . piece over KS k steps, A a K-major tile in shared memory (SS).
template <int KS, bool MN>
__device__ __forceinline__ void mma_ss(float (&acc)[32], uint32_t tile, uint32_t piece,
                                       bool accumulate) {
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    wgmma_n64_ss<0, MN ? 1 : 0>(acc, kdesc(tile, ks), MN ? mdesc(piece, ks) : kdesc(piece, ks),
                                (accumulate || ks > 0) ? 1 : 0);
  wg_commit();
  wg_wait<0>();
  fence_regs(acc);
}

// ------------------------------------------------- 64-column passes
// A pass holds the thread's 32 values of 64 columns (Rows): y[4 j + e] at
// row r0, y[4 j + 2 + e] at row r0 + 8, column 8 j + 2 t + e.

// bf16 pairs of J / 2 16-column steps to out (at the pass's first column,
// row stride ld), rows past M skipped.
template <int J>
__device__ __forceinline__ void store_bf16(const float (&y)[4 * J], bf16* out, int ld, int m0,
                                           int M, const Rows& rw) {
  const int ra = m0 + rw.r0, rb = ra + 8;
  bf16* pa = out + (size_t)ra * ld + 2 * rw.t;
  bf16* pb = out + (size_t)rb * ld + 2 * rw.t;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (ra < M) *reinterpret_cast<uint32_t*>(pa + 8 * j) = pack_bf16(y[4 * j], y[4 * j + 1]);
    if (rb < M)
      *reinterpret_cast<uint32_t*>(pb + 8 * j) = pack_bf16(y[4 * j + 2], y[4 * j + 3]);
  }
}

__device__ __forceinline__ void store_f32(const float (&y)[32], float* out, int ld, int m0,
                                          int M, const Rows& rw) {
  const int ra = m0 + rw.r0, rb = ra + 8;
  float* pa = out + (size_t)ra * ld + 2 * rw.t;
  float* pb = out + (size_t)rb * ld + 2 * rw.t;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (ra < M) *reinterpret_cast<float2*>(pa + 8 * j) = make_float2(y[4 * j], y[4 * j + 1]);
    if (rb < M)
      *reinterpret_cast<float2*>(pb + 8 * j) = make_float2(y[4 * j + 2], y[4 * j + 3]);
  }
}

// fp32 pairs of a pass from src (at the pass's first column), rows past M 0.
__device__ __forceinline__ void load_f32(float (&y)[32], const float* src, int ld, int m0,
                                         int M, const Rows& rw) {
  const int ra = m0 + rw.r0, rb = ra + 8;
  const float* pa = src + (size_t)ra * ld + 2 * rw.t;
  const float* pb = src + (size_t)rb * ld + 2 * rw.t;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 u = ra < M ? *reinterpret_cast<const float2*>(pa + 8 * j) : make_float2(0.f, 0.f);
    const float2 w = rb < M ? *reinterpret_cast<const float2*>(pb + 8 * j) : make_float2(0.f, 0.f);
    y[4 * j] = u.x;
    y[4 * j + 1] = u.y;
    y[4 * j + 2] = w.x;
    y[4 * j + 3] = w.y;
  }
}

// Pass q's values rounded into the A fragments a[4 q .. 4 q + 3].
template <int KS>
__device__ __forceinline__ void frags64(const float (&y)[32], uint32_t (&a)[KS][4], int q) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a[4 * q + j / 2][2 * (j % 2)] = pack_bf16(y[4 * j], y[4 * j + 1]);
    a[4 * q + j / 2][2 * (j % 2) + 1] = pack_bf16(y[4 * j + 2], y[4 * j + 3]);
  }
}

// Values of J 8-column groups from column col0 (a multiple of 64), rounded
// to bf16, into a K-major A tile of 64-column boxes (the 128-byte swizzle
// load_swizzled writes).
template <int J>
__device__ __forceinline__ void tile_put(uint8_t* tile, const float (&y)[4 * J], int col0,
                                         const Rows& rw) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int col = col0 + 8 * j;
    uint8_t* box = tile + (col / 64) * kBox + 4 * rw.t;
    const int grp = (col % 64) / 8;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = rw.r0 + 8 * rr;
      *reinterpret_cast<uint32_t*>(box + r * 128 + ((grp ^ (r % 8)) << 4)) =
          pack_bf16(y[4 * j + 2 * rr], y[4 * j + 2 * rr + 1]);
    }
  }
}

// The pass's column sums over the warp's 16 rows from the thread's sums of
// its two rows, s[2 j + e] at column 8 j + 2 t + e (the 8 quads added by
// xor shuffles, a fixed order), into red[warp * ld + column].
__device__ __forceinline__ void colsum_pairs(float (&s)[16], float* red, int ld,
                                             const Rows& rw) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) s[i] += __shfl_xor_sync(0xffffffffu, s[i], off);
  if ((threadIdx.x & 31) < 4) {
    float* r = red + (threadIdx.x / 32) * ld + 2 * rw.t;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      r[8 * j] = s[2 * j];
      r[8 * j + 1] = s[2 * j + 1];
    }
  }
}
__device__ __forceinline__ void colsum64(const float (&y)[32], float* red, int ld,
                                         const Rows& rw) {
  float s[16];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) s[2 * j + e] = y[4 * j + e] + y[4 * j + 2 + e];
  colsum_pairs(s, red, ld, rw);
}

// The block's column sums: the four warps' in order, to out[0 .. n).
__device__ __forceinline__ void flush_colsums(const float* red, int n, float* out) {
  __syncthreads();
  for (int c = threadIdx.x; c < n; c += kThreads)
    out[c] = ((red[c] + red[n + c]) + red[2 * n + c]) + red[3 * n + c];
}

// LayerNorm's VJP coefficients of a row (the quirky LN: unbiased variance,
// eps on the std) from its sums over the row: sgad = sum g a d, sga = sum
// g a, sd = sum d (d = x - mean).  dx = g a inv + d coef - mdd.
__device__ __forceinline__ void ln_bwd_coef(float var, float sgad, float sga, float sd, float D,
                                            float& inv, float& coef, float& mdd) {
  const float std = sqrtf(var);
  inv = 1.f / (std + 1e-6f);
  const float dden = -sgad * inv * inv;
  const float dvar = var > 0.f ? dden / (2.f * std) : 0.f;
  coef = 2.f * dvar / (D - 1.f);
  mdd = (sga * inv + coef * sd) / D;
}

// Dynamic shared memory from a 1024-byte aligned base.
__device__ __forceinline__ uint8_t* aligned_smem(uint32_t* base) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  *base = (raw + 1023) & ~1023u;
  return smem_raw + (*base - raw);
}

// ------------------------------------------------------ 1. the front

struct FrontArgs {
  CUtensorMap w[3];       // q, k, v weights, K-major pieces
  const bf16* b[3];
  const bf16* ln_a;
  const bf16* ln_b;
  const float* x;         // [M, D] the layer's input
  bf16* xn;               // [M, D] LN1's output
  bf16* qkv;              // [M, 3D]
  float* stats;           // [M, 2] LN1's row mean and variance
  float q_scale;
  int M;
};

template <int D>
constexpr int front_smem() { return 1024 + kRingBytes + BM * (D + 4) * 4 + 8 * kSlots; }

template <int D>
__global__ void __launch_bounds__(kThreads) front_kernel(const __grid_constant__ FrontArgs c) {
  constexpr int NP = D / 128, NQ = D / 64, RS = D + 4;
  uint32_t base;
  uint8_t* smem = aligned_smem(&base);
  float* res = reinterpret_cast<float*>(smem + kRingBytes);
  const int m0 = blockIdx.x * BM, M = c.M;
  const Rows rw;
  for (int i = threadIdx.x; i < BM * D / 4; i += kThreads) {
    const int r = i / (D / 4), ch = i % (D / 4);
    const bool ok = m0 + r < M;
    cp_async<16>(res + r * RS + 4 * ch, c.x + (size_t)(ok ? m0 + r : 0) * D + 4 * ch, ok);
  }
  cp_async_commit();
  auto piece = [&](int i) {
    const int m = i / NQ;
    return Piece{m == 0 ? &c.w[0] : m == 1 ? &c.w[1] : &c.w[2], 64 * (i % NQ), D, false};
  };
  Ring<decltype(piece)> ring(base, base + kRingBytes + BM * RS * 4, 3 * NQ, piece);
  ring.init();
  __syncthreads();
  ring.start();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t a[D / 16][4];
  {
    float v[NP][64], mean[2], var[2];
    read_rows(v, res, RS, rw);
    layer_norm(v, c.ln_a, c.ln_b, rw.t, mean, var);
    if (rw.t == 0) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int m = m0 + rw.r0 + 8 * rr;
        if (m < M) *reinterpret_cast<float2*>(c.stats + 2 * (size_t)m) = make_float2(mean[rr], var[rr]);
      }
    }
#pragma unroll
    for (int p = 0; p < NP; ++p) store_bf16<16>(v[p], c.xn + 128 * p, D, m0, M, rw);
    to_frags(v, a);
  }
  for (int i = 0; i < 3 * NQ; ++i) {
    const int m = i / NQ, n0 = 64 * (i % NQ);
    const bf16* bias = (m == 0 ? c.b[0] : m == 1 ? c.b[1] : c.b[2]) + n0;
    float2 bv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) bv[j] = load_pair(bias + 8 * j + 2 * rw.t);
    float acc[32];
    mma_rs<D / 16, false>(acc, a, ring.ready());
    ring.release();
    const float s = m == 0 ? c.q_scale : 1.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[4 * j] = (acc[4 * j] + bv[j].x) * s;
      acc[4 * j + 1] = (acc[4 * j + 1] + bv[j].y) * s;
      acc[4 * j + 2] = (acc[4 * j + 2] + bv[j].x) * s;
      acc[4 * j + 3] = (acc[4 * j + 3] + bv[j].y) * s;
    }
    store_bf16<8>(acc, c.qkv + m * D + n0, 3 * D, m0, M, rw);
  }
}

// ------------------------------------------------- 2, 4, 5. attention

struct AttnArgs {
  CUtensorMap qkv;   // [B, T, 3D]: boxes of 64 rows x DK
  CUtensorMap dout;  // [B, T, D]: the same boxes of do
  const bf16* qkv_p;
  const bf16* do_p;
  const float* kmask;  // [B, T]
  bf16* o;             // [B, T, D]
  float2* rowstat;     // [B, H, T]: the row's max m times log2 e and 1 / sum p
  float* dsum;         // [B, H, T]: D_i
  bf16* dqkv;          // [B, T, 3D]
  Drop site;
  float inv_sqrt_dk;
  int T, D, H;
};

// The attention kernels' shared memory: two slots of two boxes, barriers.
inline int attn_smem(int DK) { return 1024 + 4 * 64 * DK * 2 + 16; }

// A block's view of one (64-row tile, head, video): the two-slot ring of
// tiles (two boxes each: k, v or q, do), the thread's rows, and the tile
// loads.
template <int DK>
struct AttnTile {
  static constexpr int KS = DK / 16;                   // k steps of a DK-deep product
  static constexpr int kBoxB = 64 * DK * 2;
  static constexpr int kGroup = 8 * DK * 2;            // 8 rows: the descriptors' stride
  static constexpr uint64_t kSw = DK == 32 ? 2 : 3;    // 64B or 32B
  uint32_t base, bars;
  int b, hd, r0, t, lane;
  __device__ AttnTile() {
    aligned_smem(&base);
    bars = base + 4 * kBoxB;
    b = blockIdx.z;
    hd = blockIdx.y;
    lane = threadIdx.x % 32;
    r0 = 16 * (threadIdx.x / 32) + lane / 4;
    t = lane % 4;
    if (threadIdx.x == 0) {
      mbar_init(bars, 1);
      mbar_init(bars + 8, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  __device__ uint32_t slot(int i) const { return base + (i % 2) * 2 * kBoxB; }
  // load i: the boxes at columns c0, c1 of rows row0.. into slot i % 2
  __device__ void load(int i, const CUtensorMap* m0, int c0, const CUtensorMap* m1, int c1,
                       int row0) const {
    if (threadIdx.x == 0) {
      const uint32_t bar = bars + 8 * (i % 2);
      mbar_arrive_tx(bar, 2 * kBoxB);
      tma_load(slot(i), m0, c0, row0, b, bar);
      tma_load(slot(i) + kBoxB, m1, c1, row0, b, bar);
    }
  }
  __device__ void wait(int i) const { mbar_wait(bars + 8 * (i % 2), (i / 2) & 1); }
  // B K-major over the box's DK columns, k step ks; B MN-major over 16 rows kk
  __device__ uint64_t kdesc(uint32_t box, int ks) const {
    return smem_desc(box + 32 * ks, kGroup, kSw);
  }
  __device__ uint64_t mdesc(uint32_t box, int kk) const {
    return smem_desc(box + 16 * kk * DK * 2, kGroup, kSw);
  }
  // A fragments of rows r, r + 8 (below T, else 0) at columns col0.. of a
  // [B, T, width] bf16 tensor
  __device__ void frags(uint32_t (&a)[KS][4], const bf16* src, int width, int col0, int T,
                        int r) const {
    const bf16* p = src + (size_t)b * T * width + col0;
    auto ld = [&](int row, int col) -> uint32_t {
      return row < T ? *reinterpret_cast<const uint32_t*>(p + (size_t)row * width + col) : 0u;
    };
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int col = 16 * ks + 2 * t;
      a[ks][0] = ld(r, col);
      a[ks][1] = ld(r + 8, col);
      a[ks][2] = ld(r, col + 8);
      a[ks][3] = ld(r + 8, col + 8);
    }
  }
  // bf16 pairs of a DK-wide result (rows r, r + 8 below T) into [B, T, width]
  __device__ void store(const float (&o)[DK / 2], bf16* dst, int width, int col0, int T, int r,
                        float s0, float s1) const {
    bf16* p = dst + (size_t)b * T * width + col0 + 2 * t;
#pragma unroll
    for (int j = 0; j < DK / 8; ++j) {
      if (r < T)
        *reinterpret_cast<uint32_t*>(p + (size_t)r * width + 8 * j) =
            pack_bf16(o[4 * j] * s0, o[4 * j + 1] * s0);
      if (r + 8 < T)
        *reinterpret_cast<uint32_t*>(p + (size_t)(r + 8) * width + 8 * j) =
            pack_bf16(o[4 * j + 2] * s1, o[4 * j + 3] * s1);
    }
  }
};

// Bit words of a 64-key tile from k0: kept (mask != 0 and below T), below T.
__device__ __forceinline__ void key_words(const float* km, int k0, int T, int lane,
                                          uint32_t (&kw)[2], uint32_t (&lw)[2]) {
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const int key = k0 + 32 * w + lane;
    kw[w] = __ballot_sync(0xffffffffu, key < T && km[key] != 0.f);
    lw[w] = __ballot_sync(0xffffffffu, key < T);
  }
}
__device__ __forceinline__ bool word_bit(const uint32_t (&w)[2], int j, int t, int e) {
  return (w[j >> 2] >> (8 * (j & 3) + 2 * t + e)) & 1u;
}

// 2. The attention forward with dropout: o and, with kStats, each row's
// max and sum (kernel 4 rebuilds P from them; kernel 3 needs o alone).
// kH4: the site draws the "hash4" stream's multi-bit keep bits (T % 4 ==
// 0), else the per-element bits (common.cuh DropBits::keep_at); likewise
// in 4. and 5.
template <int DK, bool kStats, bool kH4>
__global__ void __launch_bounds__(kThreads) attn_fwd_kernel(const __grid_constant__ AttnArgs c) {
  using A = AttnTile<DK>;
  const A at;
  const int T = c.T, D = c.D, nt = (T + 63) / 64, q0 = blockIdx.x * 64;
  const int kc = D + at.hd * DK, vc = 2 * D + at.hd * DK;
  at.load(0, &c.qkv, kc, &c.qkv, vc, 0);
  if (nt > 1) at.load(1, &c.qkv, kc, &c.qkv, vc, 64);
  uint32_t qa[A::KS][4];
  const int r0 = q0 + at.r0, r1 = r0 + 8;
  at.frags(qa, c.qkv_p, 3 * D, at.hd * DK, T, r0);
  const float* km = c.kmask + (size_t)at.b * T;
  const uint32_t pbase = ((uint32_t)at.b * c.H + at.hd) * (uint32_t)T;
  float o[DK / 2];
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) o[i] = 0.f;
  float m0 = kMaskedScore, m1 = kMaskedScore, l0 = 0.f, l1 = 0.f;
  for (int it = 0; it < nt; ++it) {
    const int k0 = 64 * it;
    const uint32_t kb = at.slot(it), vb = kb + A::kBoxB;
    uint32_t kw[2], lw[2];
    key_words(km, k0, T, at.lane, kw, lw);
    at.wait(it);
    float s[32];
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < A::KS; ++ks) wgmma_n64(s, qa[ks], at.kdesc(kb, ks), ks);
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (!word_bit(kw, j, at.t, e)) {
          const float fill = word_bit(lw, j, at.t, e) ? kMaskedScore : -INFINITY;
          s[4 * j + e] = fill;
          s[4 * j + 2 + e] = fill;
        }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = ex2((m0 - mn0) * kLog2e), a1 = ex2((m1 - mn1) * kLog2e);
    m0 = mn0;
    m1 = mn1;
    const float ml0 = mn0 * kLog2e, ml1 = mn1 * kLog2e;
    // the sums take every p; p v the kept ones / keep_p, rounded to bf16
    uint32_t pa[4][4];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = ex2(fmaf(s[4 * j + i], kLog2e, (i & 2) ? -ml1 : -ml0));
        if (i & 2) sum1 += p[i]; else sum0 += p[i];
        const int q = (i & 2) ? r1 : r0, key = k0 + 8 * j + 2 * at.t + (i & 1);
        p[i] = c.site.apply_at<kH4>(p[i], pbase + (uint32_t)q, (uint32_t)key,
                                    (uint32_t)T);
      }
      pa[j / 2][2 * (j % 2)] = pack_bf16(p[0], p[1]);
      pa[j / 2][2 * (j % 2) + 1] = pack_bf16(p[2], p[3]);
    }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
#pragma unroll
    for (int j = 0; j < DK / 8; ++j) {
      o[4 * j] *= a0;
      o[4 * j + 1] *= a0;
      o[4 * j + 2] *= a1;
      o[4 * j + 3] *= a1;
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_pv<DK>(o, pa[kk], at.mdesc(vb, kk));
    wg_commit();
    wg_wait<0>();
    fence_regs(o);
    __syncthreads();  // the slot is free
    if (it + 2 < nt) at.load(it + 2, &c.qkv, kc, &c.qkv, vc, 64 * (it + 2));
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  at.store(o, c.o, D, at.hd * DK, T, r0, 1.f / l0, 1.f / l1);
  // P = 2^(s log2 e - m log2 e) / l rebuilds the probabilities, as the
  // last tile computed p (a video with no key too, whose every score is the
  // max -1e9)
  if (kStats && at.t == 0) {
    if (r0 < T) c.rowstat[pbase + r0] = make_float2(m0 * kLog2e, 1.f / l0);
    if (r1 < T) c.rowstat[pbase + r1] = make_float2(m1 * kLog2e, 1.f / l1);
  }
}

// 4. dq and D_i of one (64 queries, head, video).
template <int DK, bool kH4>
__global__ void __launch_bounds__(kThreads) attn_dq_kernel(const __grid_constant__ AttnArgs c) {
  using A = AttnTile<DK>;
  const A at;
  const int T = c.T, D = c.D, nt = (T + 63) / 64, q0 = blockIdx.x * 64;
  const int kc = D + at.hd * DK, vc = 2 * D + at.hd * DK;
  // two sweeps over the key tiles: loads i = sweep nt + tile
  at.load(0, &c.qkv, kc, &c.qkv, vc, 0);
  at.load(1, &c.qkv, kc, &c.qkv, vc, 64 * (1 % nt));
  uint32_t qa[A::KS][4], da[A::KS][4];
  const int r0 = q0 + at.r0, r1 = r0 + 8;
  at.frags(qa, c.qkv_p, 3 * D, at.hd * DK, T, r0);
  at.frags(da, c.do_p, D, at.hd * DK, T, r0);
  const float* km = c.kmask + (size_t)at.b * T;
  const uint32_t pbase = ((uint32_t)at.b * c.H + at.hd) * (uint32_t)T;
  const float2 st0 = r0 < T ? c.rowstat[pbase + r0] : make_float2(0.f, 0.f);
  const float2 st1 = r1 < T ? c.rowstat[pbase + r1] : make_float2(0.f, 0.f);
  float di0 = 0.f, di1 = 0.f, ps0 = 0.f, ps1 = 0.f;
  float dq[DK / 2];
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) dq[i] = 0.f;
  for (int i = 0; i < 2 * nt; ++i) {
    const int it = i % nt, sweep = i / nt, k0 = 64 * it;
    const uint32_t kb = at.slot(i), vb = kb + A::kBoxB;
    uint32_t kw[2], lw[2];
    key_words(km, k0, T, at.lane, kw, lw);
    at.wait(i);
    float s[32], dp[32];
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < A::KS; ++ks) wgmma_n64(s, qa[ks], at.kdesc(kb, ks), ks);
#pragma unroll
    for (int ks = 0; ks < A::KS; ++ks) wgmma_n64(dp, da[ks], at.kdesc(vb, ks), ks);
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    uint32_t sa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float ds[4];
#pragma unroll
      for (int i2 = 0; i2 < 4; ++i2) {
        const int e = i2 & 1, rr = i2 >> 1;
        const int key = k0 + 8 * j + 2 * at.t + e;
        float P = 0.f, d = 0.f;
        if (word_bit(lw, j, at.t, e)) {
          const float sv = word_bit(kw, j, at.t, e) ? s[4 * j + i2] : kMaskedScore;
          P = ex2(fmaf(sv, kLog2e, rr ? -st1.x : -st0.x)) * (rr ? st1.y : st0.y);
          const int q = rr ? r1 : r0;
          d = c.site.apply_at<kH4>(dp[4 * j + i2], pbase + (uint32_t)q, (uint32_t)key,
                                   (uint32_t)T);
        }
        if (sweep == 0) {
          if (rr) { di1 += P * d; ps1 += P; } else { di0 += P * d; ps0 += P; }
          ds[i2] = 0.f;
        } else {  // a masked key's score is the constant -1e9: no gradient
          ds[i2] = word_bit(kw, j, at.t, e) ? P * (d - (rr ? di1 : di0)) * c.inv_sqrt_dk : 0.f;
        }
      }
      sa[j / 2][2 * (j % 2)] = pack_bf16(ds[0], ds[1]);
      sa[j / 2][2 * (j % 2) + 1] = pack_bf16(ds[2], ds[3]);
    }
    if (sweep == 0 && it == nt - 1) {
      di0 = quad_sum(di0);
      di1 = quad_sum(di1);
      ps0 = quad_sum(ps0);
      ps1 = quad_sum(ps1);
      di0 = ps0 > 0.f ? di0 / ps0 : 0.f;
      di1 = ps1 > 0.f ? di1 / ps1 : 0.f;
    }
    if (sweep == 1) {
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_pv<DK>(dq, sa[kk], at.mdesc(kb, kk));
      wg_commit();
      wg_wait<0>();
      fence_regs(dq);
    }
    __syncthreads();  // the slot is free
    if (i + 2 < 2 * nt) at.load(i + 2, &c.qkv, kc, &c.qkv, vc, 64 * ((i + 2) % nt));
  }
  at.store(dq, c.dqkv, 3 * D, at.hd * DK, T, r0, 1.f, 1.f);
  if (at.t == 0) {
    if (r0 < T) c.dsum[pbase + r0] = di0;
    if (r1 < T) c.dsum[pbase + r1] = di1;
  }
}

// 5. dk and dv of one (64 keys, head, video) over the query tiles.
template <int DK, bool kH4>
__global__ void __launch_bounds__(kThreads) attn_dkv_kernel(const __grid_constant__ AttnArgs c) {
  using A = AttnTile<DK>;
  const A at;
  const int T = c.T, D = c.D, nt = (T + 63) / 64, k0 = blockIdx.x * 64;
  const int qc = at.hd * DK;
  at.load(0, &c.qkv, qc, &c.dout, qc, 0);
  if (nt > 1) at.load(1, &c.qkv, qc, &c.dout, qc, 64);
  uint32_t ka[A::KS][4], va[A::KS][4];
  const int r0 = k0 + at.r0, r1 = r0 + 8;  // the thread's keys
  at.frags(ka, c.qkv_p, 3 * D, D + qc, T, r0);
  at.frags(va, c.qkv_p, 3 * D, 2 * D + qc, T, r0);
  const float* km = c.kmask + (size_t)at.b * T;
  const bool masked0 = r0 >= T || km[r0] == 0.f, masked1 = r1 >= T || km[r1] == 0.f;
  const uint32_t pbase = ((uint32_t)at.b * c.H + at.hd) * (uint32_t)T;
  const float sc = c.site.scale;
  float dk[DK / 2], dv[DK / 2];
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) dk[i] = dv[i] = 0.f;
  for (int it = 0; it < nt; ++it) {
    const int q0 = 64 * it;
    const uint32_t qb = at.slot(it), ob = qb + A::kBoxB;
    float2 st[16];  // the row statistics and D of the thread's 16 queries
    float di[16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = q0 + 8 * j + 2 * at.t + e;
        st[2 * j + e] = q < T ? c.rowstat[pbase + q] : make_float2(0.f, 0.f);
        di[2 * j + e] = q < T ? c.dsum[pbase + q] : 0.f;
      }
    at.wait(it);
    float s[32], dp[32];
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < A::KS; ++ks) wgmma_n64(s, ka[ks], at.kdesc(qb, ks), ks);
#pragma unroll
    for (int ks = 0; ks < A::KS; ++ks) wgmma_n64(dp, va[ks], at.kdesc(ob, ks), ks);
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    uint32_t pa[4][4], sa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float pd[4], ds[4];
#pragma unroll
      for (int i2 = 0; i2 < 4; ++i2) {
        const int e = i2 & 1, rr = i2 >> 1;
        const int q = q0 + 8 * j + 2 * at.t + e, key = rr ? r1 : r0;
        pd[i2] = 0.f;
        ds[i2] = 0.f;
        if (q < T) {
          const float sv = (rr ? masked1 : masked0) ? kMaskedScore : s[4 * j + i2];
          const float P = ex2(fmaf(sv, kLog2e, -st[2 * j + e].x)) * st[2 * j + e].y;
          const bool kept =
              c.site.keep_at<kH4>(pbase + (uint32_t)q, (uint32_t)key, (uint32_t)T);
          pd[i2] = kept ? P * sc : 0.f;
          // a masked key's score is the constant -1e9: no gradient
          if (!(rr ? masked1 : masked0)) ds[i2] = P * ((kept ? dp[4 * j + i2] * sc : 0.f) - di[2 * j + e]);
        }
      }
      pa[j / 2][2 * (j % 2)] = pack_bf16(pd[0], pd[1]);
      pa[j / 2][2 * (j % 2) + 1] = pack_bf16(pd[2], pd[3]);
      sa[j / 2][2 * (j % 2)] = pack_bf16(ds[0], ds[1]);
      sa[j / 2][2 * (j % 2) + 1] = pack_bf16(ds[2], ds[3]);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_pv<DK>(dv, pa[kk], at.mdesc(ob, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_pv<DK>(dk, sa[kk], at.mdesc(qb, kk));
    wg_commit();
    wg_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    __syncthreads();  // the slot is free
    if (it + 2 < nt) at.load(it + 2, &c.qkv, qc, &c.dout, qc, 64 * (it + 2));
  }
  at.store(dk, c.dqkv, 3 * D, D + qc, T, r0, 1.f, 1.f);
  at.store(dv, c.dqkv, 3 * D, 2 * D + qc, T, r0, 1.f, 1.f);
}

// ------------------------------------------------- 3. the middle chain

// Column sums a block writes: the middle chain's b2 | b1 | ln2.a | ln2.b |
// out.b, then the back chain's ln1.a | ln1.b | q.b | k.b | v.b.
inline int mid_cols(int D, int F) { return 4 * D + F; }
inline int all_cols(int D, int F) { return 9 * D + F; }

struct MidArgs {
  CUtensorMap wo_k, w1_k;        // out projection and FFN1, K-major pieces
  CUtensorMap w2_m, w1_m, wo_m;  // dmid = dff W2, dxn2 = dmidp W1, do = dattn Wo: MN-major
  const bf16* bo;
  const bf16* b1;
  const bf16* ln2a;
  const bf16* ln2b;
  const bf16* o;     // [M, D] the attention output
  const float* x;    // [M, D] the layer's input
  const float* dy;   // [M, D]
  bf16* xn2;         // [M, D]
  bf16* mid;         // [M, F] dropout(relu(midp)), FFN2's input
  bf16* dff;         // [M, D]
  bf16* dmidp;       // [M, F]
  bf16* dattn;       // [M, D]
  bf16* dout;        // [M, D] do
  float* dx1;        // [M, D]
  float* colpart;    // [blocks, all_cols]
  Drop s1, s2, s3;
  int M, CW;
};

template <int D, int F>
struct MidSmem {
  static constexpr int kTile = kRingBytes;
  static constexpr int kRes = kTile + BM * D * 2;
  static constexpr int kRed = kRes + BM * (D + 4) * 4;
  static constexpr int kBars = kRed + 4 * (4 * D + F) * 4;
  static constexpr int bytes = 1024 + kBars + 8 * kSlots;
};
static_assert(MidSmem<256, 128>::bytes <= kMaxSmem, "the middle chain's shared memory");

template <int D, int F, bool kH4>
__global__ void __launch_bounds__(kThreads) mid_kernel(const __grid_constant__ MidArgs c) {
  using S = MidSmem<D, F>;
  constexpr int NP = D / 128, NQ = D / 64, FQ = F / 64, RS = D + 4, KD = D / 16, KF = F / 16;
  constexpr int CR = 4 * D + F;
  uint32_t base;
  uint8_t* smem = aligned_smem(&base);
  uint8_t* tile = smem + S::kTile;  // the A operand: o, then xn2, dff, dattn
  const uint32_t tile_u = base + S::kTile;
  float* res = reinterpret_cast<float*>(smem + S::kRes);
  float* red = reinterpret_cast<float*>(smem + S::kRed);
  const int m0 = blockIdx.x * BM, M = c.M;
  const Rows rw;
  const int ra = m0 + rw.r0;  // the thread's first row (the second is ra + 8)
  load_swizzled<D>(tile, c.o + (size_t)m0 * D, M - m0);
  for (int i = threadIdx.x; i < BM * D / 4; i += kThreads) {
    const int r = i / (D / 4), ch = i % (D / 4);
    const bool ok = m0 + r < M;
    cp_async<16>(res + r * RS + 4 * ch, c.x + (size_t)(ok ? m0 + r : 0) * D + 4 * ch, ok);
  }
  cp_async_commit();
  auto piece = [&](int i) {
    if (i < NQ) return Piece{&c.wo_k, 64 * i, D, false};
    i -= NQ;
    if (i < FQ) return Piece{&c.w1_k, 64 * i, D, false};
    i -= FQ;
    if (i < FQ) return Piece{&c.w2_m, 64 * i, D, true};
    i -= FQ;
    if (i < 2 * NQ) return Piece{&c.w1_m, 64 * (i % NQ), F, true};  // dxn2, twice
    return Piece{&c.wo_m, 64 * (i - 2 * NQ), D, true};
  };
  Ring<decltype(piece)> ring(base, base + S::kBars, 4 * NQ + 2 * FQ, piece);
  ring.init();
  __syncthreads();
  ring.start();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  // the tile's next contents are visible to wgmma
  auto tile_ready = [&]() {
    fence_proxy_async();
    __syncthreads();
  };

  float acc[32];
  // x1 = x + dropout(o Wo^T + bo) in the residual rows
  for (int q = 0; q < NQ; ++q) {
    float2 bv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) bv[j] = load_pair(c.bo + 64 * q + 8 * j + 2 * rw.t);
    mma_ss<KD, false>(acc, tile_u, ring.ready(), false);
    ring.release();
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rr = i >> 1, col = 64 * q + 8 * j + 2 * rw.t + (i & 1);
        const float bias = (i & 1) ? bv[j].y : bv[j].x;
        res[(rw.r0 + 8 * rr) * RS + col] +=
            c.s1.apply_at<kH4>(acc[4 * j + i] + bias, ra + 8 * rr, col, D);
      }
  }
  // LN2: xn2, stored and into the tile
  float mean2[2], var2[2];
  {
    float v[NP][64];
    read_rows(v, res, RS, rw);
    layer_norm(v, c.ln2a, c.ln2b, rw.t, mean2, var2);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      store_bf16<16>(v[p], c.xn2 + 128 * p, D, m0, M, rw);
      tile_put<16>(tile, v[p], 128 * p, rw);
    }
  }
  tile_ready();
  // FFN1: midp's ReLU mask; dropout(relu(midp)) stored for dW2
  uint64_t relu = 0;  // bit 32 q + 4 j + i: midp > 0
  for (int q = 0; q < FQ; ++q) {
    float2 bv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) bv[j] = load_pair(c.b1 + 64 * q + 8 * j + 2 * rw.t);
    mma_ss<KD, false>(acc, tile_u, ring.ready(), false);
    ring.release();
    uint32_t bits = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = 64 * q + 8 * j + 2 * rw.t + (i & 1);
        const float v = acc[4 * j + i] + ((i & 1) ? bv[j].y : bv[j].x);
        if (v > 0.f) bits |= 1u << (4 * j + i);
        acc[4 * j + i] = c.s2.apply_at<kH4>(fmaxf(v, 0.f), ra + 8 * (i >> 1), col, F);
      }
    relu |= (uint64_t)bits << (32 * q);
    store_bf16<8>(acc, c.mid + 64 * q, F, m0, M, rw);
  }
  // dff = site-3 dropout of dy: column sums (b2), stored, into the tile
  for (int q = 0; q < NQ; ++q) {
    load_f32(acc, c.dy + 64 * q, D, m0, M, rw);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[4 * j + i] = c.s3.apply_at<kH4>(acc[4 * j + i], ra + 8 * (i >> 1),
                                       64 * q + 8 * j + 2 * rw.t + (i & 1), D);
    colsum64(acc, red + 64 * q, CR, rw);
    store_bf16<8>(acc, c.dff + 64 * q, D, m0, M, rw);
    tile_put<8>(tile, acc, 64 * q, rw);
  }
  tile_ready();
  // dmidp = relu'(midp) site-2 dropout'(dff W2): column sums (b1), stored, fragments
  uint32_t h[KF][4];
#pragma unroll
  for (int q = 0; q < FQ; ++q) {
    mma_ss<KD, true>(acc, tile_u, ring.ready(), false);
    ring.release();
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = 64 * q + 8 * j + 2 * rw.t + (i & 1);
        acc[4 * j + i] = (relu >> (32 * q + 4 * j + i)) & 1u
                             ? c.s2.apply_at<kH4>(acc[4 * j + i], ra + 8 * (i >> 1), col,
                                                  F)
                             : 0.f;
      }
    colsum64(acc, red + D + 64 * q, CR, rw);
    store_bf16<8>(acc, c.dmidp + 64 * q, F, m0, M, rw);
    frags64(acc, h, q);
  }
  // dxn2 = dmidp W1, twice (the same bits): first for LN2's backward's row
  // sums, then for its outputs, so that dxn2 never stays whole in registers
  float sgad[2] = {0.f, 0.f}, sga[2] = {0.f, 0.f}, sd[2] = {0.f, 0.f};
  for (int q = 0; q < NQ; ++q) {
    mma_rs<KF, true>(acc, h, ring.ready());
    ring.release();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 av = load_pair(c.ln2a + 64 * q + 8 * j + 2 * rw.t);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rr = i >> 1, col = 64 * q + 8 * j + 2 * rw.t + (i & 1);
        const float d = res[(rw.r0 + 8 * rr) * RS + col] - mean2[rr];
        const float ga = acc[4 * j + i] * ((i & 1) ? av.y : av.x);
        sgad[rr] += ga * d;
        sga[rr] += ga;
        sd[rr] += d;
      }
    }
  }
  float inv[2], coef[2], mdd[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
    ln_bwd_coef(var2[rr], quad_sum(sgad[rr]), quad_sum(sga[rr]), quad_sum(sd[rr]), (float)D,
                inv[rr], coef[rr], mdd[rr]);
  // dx1 = dy + LN2'(dxn2), stored; ln2.a, ln2.b column sums; dattn = site-1
  // dropout of dx1: column sums (out.b), stored, into the tile
  for (int q = 0; q < NQ; ++q) {
    float y[32];
    mma_rs<KF, true>(acc, h, ring.ready());
    ring.release();
    load_f32(y, c.dy + 64 * q, D, m0, M, rw);
    float sg[16], sgd[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 av = load_pair(c.ln2a + 64 * q + 8 * j + 2 * rw.t);
      sg[2 * j] = sg[2 * j + 1] = sgd[2 * j] = sgd[2 * j + 1] = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rr = i >> 1, e = i & 1, col = 64 * q + 8 * j + 2 * rw.t + e;
        const float d = res[(rw.r0 + 8 * rr) * RS + col] - mean2[rr];
        const float gv = acc[4 * j + i];
        const float dd = gv * (e ? av.y : av.x) * inv[rr] + d * coef[rr];
        y[4 * j + i] += dd - mdd[rr];
        sg[2 * j + e] += gv;
        sgd[2 * j + e] += gv * d * inv[rr];
      }
    }
    colsum_pairs(sgd, red + D + F + 64 * q, CR, rw);
    colsum_pairs(sg, red + 2 * D + F + 64 * q, CR, rw);
    store_f32(y, c.dx1 + 64 * q, D, m0, M, rw);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        y[4 * j + i] = c.s1.apply_at<kH4>(y[4 * j + i], ra + 8 * (i >> 1),
                                     64 * q + 8 * j + 2 * rw.t + (i & 1), D);
    colsum64(y, red + 3 * D + F + 64 * q, CR, rw);
    store_bf16<8>(y, c.dattn + 64 * q, D, m0, M, rw);
    tile_put<8>(tile, y, 64 * q, rw);
  }
  tile_ready();
  // do = dattn Wo
  for (int q = 0; q < NQ; ++q) {
    mma_ss<KD, true>(acc, tile_u, ring.ready(), false);
    ring.release();
    store_bf16<8>(acc, c.dout + 64 * q, D, m0, M, rw);
  }
  flush_colsums(red, CR, c.colpart + (size_t)blockIdx.x * c.CW);
}

// ------------------------------------------------- 6. the back chain

struct BackArgs {
  CUtensorMap wm[3];     // Wq, Wk, Wv MN-major
  const bf16* ln1a;
  const bf16* dqkv;      // [M, 3D]
  const float* x;        // [M, D]
  const float* stats;    // [M, 2]
  const float* dx1;      // [M, D]
  float* dx;             // [M, D]
  float* colpart;        // [blocks, all_cols], from column 4D + F
  int M, CW;
};

template <int D>
struct BackSmem {
  static constexpr int kTile = kRingBytes;
  static constexpr int kRed = kTile + BM * 3 * D * 2;
  static constexpr int kBars = kRed + 4 * 2 * D * 4;
  static constexpr int bytes = 1024 + kBars + 8 * kSlots;
};
static_assert(BackSmem<256>::bytes <= kMaxSmem, "the back chain's shared memory");

template <int D>
__global__ void __launch_bounds__(kThreads) back_kernel(const __grid_constant__ BackArgs c) {
  using S = BackSmem<D>;
  constexpr int NQ = D / 64, KD = D / 16;
  uint32_t base;
  uint8_t* smem = aligned_smem(&base);
  float* red = reinterpret_cast<float*>(smem + S::kRed);
  const int m0 = blockIdx.x * BM, M = c.M;
  const Rows rw;
  const int ra = m0 + rw.r0;
  load_swizzled<3 * D>(smem + S::kTile, c.dqkv + (size_t)m0 * 3 * D, M - m0);
  cp_async_commit();
  auto piece = [&](int i) {
    const int mi = i % 3;
    return Piece{mi == 0 ? &c.wm[0] : mi == 1 ? &c.wm[1] : &c.wm[2], 64 * (i / 3), D, true};
  };
  Ring<decltype(piece)> ring(base, base + S::kBars, 3 * NQ, piece);
  ring.init();
  __syncthreads();
  ring.start();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  // dxn1 = dq Wq + dk Wk + dv Wv
  float g[NQ][32];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int mi = 0; mi < 3; ++mi) {
      mma_ss<KD, true>(g[q], base + S::kTile + mi * (D / 64) * kBox, ring.ready(), mi > 0);
      ring.release();
    }
  // q, k, v bias gradients: the tile's column sums, rows in order
  float* cp = c.colpart + (size_t)blockIdx.x * c.CW + 4 * D + kF + 2 * D;
  for (int col = threadIdx.x; col < 3 * D; col += kThreads) {
    const uint8_t* chunk = smem + S::kTile + (col / 64) * kBox + 2 * (col % 8);
    const int grp = (col % 64) / 8;
    float s = 0.f;
    for (int r = 0; r < BM; ++r)
      s += __bfloat162float(*reinterpret_cast<const bf16*>(chunk + r * 128 + ((grp ^ (r % 8)) << 4)));
    cp[col] = s;
  }
  // LN1's backward from its saved row statistics
  float mean[2], var[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int m = ra + 8 * rr;
    const float2 st = m < M ? *reinterpret_cast<const float2*>(c.stats + 2 * (size_t)m)
                            : make_float2(0.f, 0.f);
    mean[rr] = st.x;
    var[rr] = st.y;
  }
  float sgad[2] = {0.f, 0.f}, sga[2] = {0.f, 0.f}, sd[2] = {0.f, 0.f};
  float xv[32];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    load_f32(xv, c.x + 64 * q, D, m0, M, rw);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 av = load_pair(c.ln1a + 64 * q + 8 * j + 2 * rw.t);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rr = i >> 1;
        const float d = xv[4 * j + i] - mean[rr];
        const float ga = g[q][4 * j + i] * ((i & 1) ? av.y : av.x);
        sgad[rr] += ga * d;
        sga[rr] += ga;
        sd[rr] += d;
      }
    }
  }
  float inv[2], coef[2], mdd[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
    ln_bwd_coef(var[rr], quad_sum(sgad[rr]), quad_sum(sga[rr]), quad_sum(sd[rr]), (float)D,
                inv[rr], coef[rr], mdd[rr]);
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    float out[32], sgd[16];
    load_f32(xv, c.x + 64 * q, D, m0, M, rw);
    load_f32(out, c.dx1 + 64 * q, D, m0, M, rw);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 av = load_pair(c.ln1a + 64 * q + 8 * j + 2 * rw.t);
      sgd[2 * j] = sgd[2 * j + 1] = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rr = i >> 1, e = i & 1;
        const float d = xv[4 * j + i] - mean[rr];
        const float gv = g[q][4 * j + i];
        out[4 * j + i] += gv * (e ? av.y : av.x) * inv[rr] + d * coef[rr] - mdd[rr];
        sgd[2 * j + e] += gv * d * inv[rr];
      }
    }
    colsum_pairs(sgd, red + 64 * q, 2 * D, rw);
    colsum64(g[q], red + D + 64 * q, 2 * D, rw);
    store_f32(out, c.dx + 64 * q, D, m0, M, rw);
  }
  flush_colsums(red, 2 * D, c.colpart + (size_t)blockIdx.x * c.CW + 4 * D + kF);
}

// ------------------------------------------- 7. weight-gradient partials

// dW [N, Kin] = G^T X over the rows: G [M, N] and X [M, Kin] (row strides
// ldg, ldx), the partial of each 64 x 64 tile of dW at `out` + its place.
struct GradJob {
  const bf16* G;
  const bf16* X;
  int ldg, ldx, N, Kin, tiles, out;
};
constexpr int kJobs = 6;
struct GradArgs {
  GradJob job[kJobs];
  float* part;  // [chunks][plane]
  int M, plane;
};

constexpr int grad_smem() { return 1024 + kStages * 2 * kBox; }

__global__ void __launch_bounds__(kThreads) wgrad_kernel(const __grid_constant__ GradArgs c) {
  uint32_t base;
  uint8_t* smem = aligned_smem(&base);
  // the job of this tile (no runtime index into the parameters)
  int tile = blockIdx.x;
  GradJob jb = c.job[kJobs - 1];
  bool found = false;
#pragma unroll
  for (int i = 0; i < kJobs; ++i) {
    if (!found && tile < c.job[i].tiles) {
      jb = c.job[i];
      found = true;
    } else if (!found) {
      tile -= c.job[i].tiles;
    }
  }
  const int nt = jb.N / 64;
  const int n0 = 64 * (tile % nt), k0 = 64 * (tile / nt);
  const int rb = blockIdx.y * kChunkRows, re = min(c.M, rb + kChunkRows);
  const int steps = (re - rb + 63) / 64;
  auto load = [&](int s) {  // rows rb + 64 s.. of G's and X's columns into stage s % kStages
    uint8_t* gt = smem + (s % kStages) * 2 * kBox;
    uint8_t* xt = gt + kBox;
    for (int i = threadIdx.x; i < 2 * BM * 8; i += kThreads) {
      const int which = i / (BM * 8), r = (i / 8) % BM, gk = i % 8;
      const int row = rb + 64 * s + r;
      const bool ok = row < re;
      const bf16* src = which == 0 ? jb.G + (size_t)(ok ? row : 0) * jb.ldg + n0
                                   : jb.X + (size_t)(ok ? row : 0) * jb.ldx + k0;
      cp_async<16>((which == 0 ? gt : xt) + r * 128 + ((gk ^ (r % 8)) << 4), src + 8 * gk, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();
    if (it + kStages - 1 < steps) load(it + kStages - 1);
    cp_async_commit();
    const uint32_t gt = base + (it % kStages) * 2 * kBox, xt = gt + kBox;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_n64_ss<1, 1>(acc, mdesc(gt, kk), mdesc(xt, kk), 1);
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
  }
  const Rows rw;
  float* out = c.part + (size_t)blockIdx.y * c.plane + jb.out + (size_t)n0 * jb.Kin + k0;
  store_f32(acc, out, jb.Kin, 0, BM, rw);
}

// ------------------------------------------------------------- 8. sums

constexpr int kSums = 16;
struct SumArgs {
  const float* part;     // [chunks][plane]
  const float* colpart;  // [blocks][cols]
  float* out[kSums];     // where each piece of the two planes goes, in order
  int end[kSums];        // the pieces' ends in the concatenation of both planes
  int chunks, plane, blocks, cols;
};

// Each output element: its weight partials over the chunks, or its column
// sums over the row blocks, added in order, compensated.
__global__ void sum_kernel(const __grid_constant__ SumArgs c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= c.plane + c.cols) return;
  KahanSum s;
  if (i < c.plane) {
    for (int z = 0; z < c.chunks; ++z) s.add(c.part[(size_t)z * c.plane + i]);
  } else {
    for (int b = 0; b < c.blocks; ++b) s.add(c.colpart[(size_t)b * c.cols + (i - c.plane)]);
  }
  float* dst = nullptr;
  int begin = 0;
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    if (dst == nullptr && i < c.end[k]) dst = c.out[k] + (i - begin);
    begin = c.end[k];
  }
  *dst = s.s;
}

// ------------------------------------------------------------ the host

struct Work {
  bf16 *xn1, *qkv, *o, *xn2, *mid, *dff, *dmidp, *dattn, *dout, *dqkv;
  float *dx1, *stats, *dsum, *colpart, *part;
  float2* rowstat;
  static Work carve(Carver& c, int B, int T, int D, int H, int F) {
    const size_t M = (size_t)B * T;
    Work w;
    w.xn1 = c.take<bf16>(M * D);
    w.qkv = c.take<bf16>(M * 3 * D);
    w.o = c.take<bf16>(M * D);
    w.xn2 = c.take<bf16>(M * D);
    w.mid = c.take<bf16>(M * F);
    w.dff = c.take<bf16>(M * D);
    w.dmidp = c.take<bf16>(M * F);
    w.dattn = c.take<bf16>(M * D);
    w.dout = c.take<bf16>(M * D);
    w.dqkv = c.take<bf16>(M * 3 * D);
    w.dx1 = c.take<float>(M * D);
    w.stats = c.take<float>(M * 2);
    w.rowstat = c.take<float2>((size_t)B * H * T);
    w.dsum = c.take<float>((size_t)B * H * T);
    w.colpart = c.take<float>((M + BM - 1) / BM * all_cols(D, F));
    w.part = c.take<float>((M + kChunkRows - 1) / kChunkRows * (4 * (size_t)D * D + 2 * (size_t)D * F));
    return w;
  }
};

template <typename Kernel>
int allow_smem(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Launches Kernel on grid with `smem` bytes of dynamic shared memory (the
// opt-in set once per kernel: each kernel takes one size).
template <auto Kernel, typename Args>
int launch(dim3 grid, int smem, const Args& args, cudaStream_t st) {
  static int setup = -1;  // cudaError_t of the one-time set-up
  if (setup < 0) setup = allow_smem(Kernel, smem);
  if (setup != 0) return setup;
  Kernel<<<grid, kThreads, smem, st>>>(args);
  return (int)cudaGetLastError();
}

template <int D, int DK>
int run_layer(const float* x, const float* dy, const float* kmask, const bf16* const* p,
              float* const* g, const uint32_t* seeds, uint32_t thr, float kp, int t8,
              float* dx, const Work& w, int B, int T, int H, cudaStream_t st) {
  constexpr int F = kF;
  const int M = B * T;
  const int blocks = (M + BM - 1) / BM, CW = all_cols(D, F);
  const float scale = 1.f / kp;
  const Drop s0 = Drop::of(seeds[0], thr, scale, t8, T),
             s1 = Drop::of(seeds[1], thr, scale, t8, D),
             s2 = Drop::of(seeds[2], thr, scale, t8, F),
             s3 = Drop::of(seeds[3], thr, scale, t8, D);
  bool ok = true;
  // 1. LN1 + q | k | v
  FrontArgs fa{};
  const int wi[3] = {WQ, WK, WV};
  for (int m = 0; m < 3; ++m) {
    ok = tile_map(&fa.w[m], p[wi[m]], D, D, 64) && ok;
    fa.b[m] = p[wi[m] + 1];
  }
  fa.ln_a = p[LN1A];
  fa.ln_b = p[LN1B];
  fa.x = x;
  fa.xn = w.xn1;
  fa.qkv = w.qkv;
  fa.stats = w.stats;
  fa.q_scale = 1.0f / sqrtf((float)DK);
  fa.M = M;
  // attention: forward, dq, dk / dv
  AttnArgs aa{};
  ok = heads_map(&aa.qkv, w.qkv, B, T, 3 * D, DK) && heads_map(&aa.dout, w.dout, B, T, D, DK) &&
       ok;
  aa.qkv_p = w.qkv;
  aa.do_p = w.dout;
  aa.kmask = kmask;
  aa.o = w.o;
  aa.rowstat = w.rowstat;
  aa.dsum = w.dsum;
  aa.dqkv = w.dqkv;
  aa.site = s0;
  aa.inv_sqrt_dk = fa.q_scale;
  aa.T = T;
  aa.D = D;
  aa.H = H;
  // 3. the middle chain
  MidArgs ma{};
  ok = tile_map(&ma.wo_k, p[WO], D, D, 64) && tile_map(&ma.w1_k, p[W1], F, D, 64) &&
       tile_map(&ma.w2_m, p[W2], D, F, D) && tile_map(&ma.w1_m, p[W1], F, D, F) &&
       tile_map(&ma.wo_m, p[WO], D, D, D) && ok;
  ma.bo = p[BO];
  ma.b1 = p[B1];
  ma.ln2a = p[LN2A];
  ma.ln2b = p[LN2B];
  ma.o = w.o;
  ma.x = x;
  ma.dy = dy;
  ma.xn2 = w.xn2;
  ma.mid = w.mid;
  ma.dff = w.dff;
  ma.dmidp = w.dmidp;
  ma.dattn = w.dattn;
  ma.dout = w.dout;
  ma.dx1 = w.dx1;
  ma.colpart = w.colpart;
  ma.s1 = s1;
  ma.s2 = s2;
  ma.s3 = s3;
  ma.M = M;
  ma.CW = CW;
  // 6. the back chain
  BackArgs ba{};
  for (int m = 0; m < 3; ++m) ok = tile_map(&ba.wm[m], p[wi[m]], D, D, D) && ok;
  ba.ln1a = p[LN1A];
  ba.dqkv = w.dqkv;
  ba.x = x;
  ba.stats = w.stats;
  ba.dx1 = w.dx1;
  ba.dx = dx;
  ba.colpart = w.colpart;
  ba.M = M;
  ba.CW = CW;
  if (!ok) return (int)cudaErrorInvalidValue;
  // 7. weight gradients: dWq dWk dWv dWo dW1 dW2, in the partial plane in that order
  GradArgs ga{};
  const int plane = 4 * D * D + 2 * D * F;
  const GradJob jobs[kJobs] = {
      {w.dqkv, w.xn1, 3 * D, D, D, D, 0, 0},
      {w.dqkv + D, w.xn1, 3 * D, D, D, D, 0, D * D},
      {w.dqkv + 2 * D, w.xn1, 3 * D, D, D, D, 0, 2 * D * D},
      {w.dattn, w.o, D, D, D, D, 0, 3 * D * D},
      {w.dmidp, w.xn2, F, D, F, D, 0, 4 * D * D},
      {w.dff, w.mid, D, F, D, F, 0, 4 * D * D + F * D}};
  int tiles = 0;
  for (int j = 0; j < kJobs; ++j) {
    ga.job[j] = jobs[j];
    ga.job[j].tiles = (jobs[j].N / 64) * (jobs[j].Kin / 64);
    tiles += ga.job[j].tiles;
  }
  ga.part = w.part;
  ga.M = M;
  ga.plane = plane;
  const int chunks = (M + kChunkRows - 1) / kChunkRows;
  // 8. the sums
  SumArgs sa{};
  sa.part = w.part;
  sa.colpart = w.colpart;
  sa.chunks = chunks;
  sa.plane = plane;
  sa.blocks = blocks;
  sa.cols = CW;
  const int order[kSums] = {WQ, WK, WV, WO, W1, W2, B2, B1, LN2A, LN2B, BO, LN1A, LN1B, BQ, BK, BV};
  const int size[kSums] = {D * D, D * D, D * D, D * D, F * D, D * F, D, F, D, D, D, D, D, D, D, D};
  int end = 0;
  for (int k = 0; k < kSums; ++k) {
    end += size[k];
    sa.out[k] = g[order[k]];
    sa.end[k] = end;
  }

  const int qt = (T + 63) / 64;
  const dim3 heads(qt, H, B);
  // the stream is each kernel's template argument: the attention site's is
  // hash4 where its width T takes it (s0.w4 > 0), the row sites' wherever
  // the stream is hash4 (D and F are multiples of 4)
  const bool a4 = s0.w4 != 0, r4 = t8 >= 0;
  const int as = attn_smem(DK);
  int rc = launch<front_kernel<D>>(dim3(blocks), front_smem<D>(), fa, st);
  if (rc == 0)
    rc = a4 ? launch<attn_fwd_kernel<DK, true, true>>(heads, as, aa, st)
            : launch<attn_fwd_kernel<DK, true, false>>(heads, as, aa, st);
  if (rc == 0)
    rc = r4 ? launch<mid_kernel<D, F, true>>(dim3(blocks), MidSmem<D, F>::bytes, ma, st)
            : launch<mid_kernel<D, F, false>>(dim3(blocks), MidSmem<D, F>::bytes, ma, st);
  if (rc == 0)
    rc = a4 ? launch<attn_dq_kernel<DK, true>>(heads, as, aa, st)
            : launch<attn_dq_kernel<DK, false>>(heads, as, aa, st);
  if (rc == 0)
    rc = a4 ? launch<attn_dkv_kernel<DK, true>>(heads, as, aa, st)
            : launch<attn_dkv_kernel<DK, false>>(heads, as, aa, st);
  if (rc == 0) rc = launch<back_kernel<D>>(dim3(blocks), BackSmem<D>::bytes, ba, st);
  if (rc == 0) rc = launch<wgrad_kernel>(dim3(tiles, chunks), grad_smem(), ga, st);
  if (rc == 0) {
    sum_kernel<<<(plane + CW + 255) / 256, 256, 0, st>>>(sa);
    rc = (int)cudaGetLastError();
  }
  return rc;
}

int layer(const float* x, const float* dy, const float* kmask, const bf16* const* p,
          float* const* g, const uint32_t* seeds, uint32_t thr, float kp, int t8, float* dx,
          const Work& w, int B, int T, int D, int H, cudaStream_t st) {
  const int dk = D / H;
  if (D == 256)
    return dk == 32
               ? run_layer<256, 32>(x, dy, kmask, p, g, seeds, thr, kp, t8, dx, w, B, T, H, st)
               : run_layer<256, 16>(x, dy, kmask, p, g, seeds, thr, kp, t8, dx, w, B, T, H, st);
  return dk == 32
             ? run_layer<128, 32>(x, dy, kmask, p, g, seeds, thr, kp, t8, dx, w, B, T, H, st)
             : run_layer<128, 16>(x, dy, kmask, p, g, seeds, thr, kp, t8, dx, w, B, T, H, st);
}

bool takes(int dtype, int D, int H, int F) {
  const int dk = H > 0 ? D / H : 0;
  return dtype == kBF16 && dk * H == D && (dk == 16 || dk == 32) && (D == 128 || D == 256) &&
         F == 128;
}

long long workspace_bytes(int B, int T, int D, int H, int F, bool stack) {
  Carver c{nullptr};
  Work::carve(c, B, T, D, H, F);
  if (stack)
    for (int i = 0; i < 2; ++i) c.take<float>((size_t)B * T * D);
  return (long long)c.used + 256;
}

int layer_bwd(const float* x, const float* dy, const float* kmask, const void* const* lp,
              const uint32_t* seeds, uint32_t thr, float kp, int t8, float* dx,
              void* const* gp, void* ws, int B, int T, int D, int H, int F, cudaStream_t st) {
  Carver c{static_cast<char*>(ws)};
  const Work w = Work::carve(c, B, T, D, H, F);
  const bf16* p[16];
  float* g[16];
  for (int i = 0; i < 16; ++i) {
    p[i] = static_cast<const bf16*>(lp[i]);
    g[i] = static_cast<float*>(gp[i]);
  }
  return layer(x, dy, kmask, p, g, seeds, thr, kp, t8, dx, w, B, T, D, H, st);
}

int stack_bwd(const float* saved, const float* dy, const float* kmask, const void* const* lp,
              int n_layers, const uint32_t* seeds, uint32_t thr, float kp, int t8, float* dx,
              void* const* gp, void* ws, int B, int T, int D, int H, int F, cudaStream_t st) {
  const size_t MD = (size_t)B * T * D;
  Carver c{static_cast<char*>(ws)};
  const Work w = Work::carve(c, B, T, D, H, F);
  float* carry[2] = {c.take<float>(MD), c.take<float>(MD)};
  const size_t n[16] = {(size_t)D, (size_t)D, (size_t)D * D, (size_t)D, (size_t)D * D,
                        (size_t)D, (size_t)D * D, (size_t)D, (size_t)D * D, (size_t)D,
                        (size_t)D, (size_t)D, (size_t)F * D, (size_t)F, (size_t)D * F,
                        (size_t)D};
  const float* g_out = dy;
  for (int l = n_layers - 1; l >= 0; --l) {
    const bf16* p[16];
    float* g[16];
    for (int i = 0; i < 16; ++i) {
      p[i] = static_cast<const bf16*>(lp[16 * l + i]);
      g[i] = static_cast<float*>(gp[i]) + (size_t)l * n[i];
    }
    float* d_in = l == 0 ? dx : carry[l & 1];
    const int rc = layer(saved + (size_t)l * MD, g_out, kmask, p, g, seeds + 4 * l, thr, kp, t8,
                         d_in, w, B, T, D, H, st);
    if (rc != 0) return rc;
    g_out = d_in;
  }
  return (int)cudaGetLastError();
}

// Kernel 3's attention: kernel 4's attention forward without the row
// statistics, on qkv [B, T, 3D] through its heads map tm, into o [B, T, D].
int train_attention(const CUtensorMap& tm, const bf16* qkv, const float* kmask, bf16* o,
                    int B, int T, int D, int H, Drop site, cudaStream_t st) {
  AttnArgs aa{};
  aa.qkv = tm;
  aa.qkv_p = qkv;
  aa.kmask = kmask;
  aa.o = o;
  aa.site = site;
  aa.T = T;
  aa.D = D;
  aa.H = H;
  const dim3 heads((T + 63) / 64, H, B);
  if (site.w4 != 0)  // the "hash4" stream at a width T % 4 == 0
    return D / H == 32 ? launch<attn_fwd_kernel<32, false, true>>(heads, attn_smem(32), aa, st)
                       : launch<attn_fwd_kernel<16, false, true>>(heads, attn_smem(16), aa, st);
  return D / H == 32 ? launch<attn_fwd_kernel<32, false, false>>(heads, attn_smem(32), aa, st)
                     : launch<attn_fwd_kernel<16, false, false>>(heads, attn_smem(16), aa, st);
}

}  // namespace enc_bwd
}  // namespace mmtx
