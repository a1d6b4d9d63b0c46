// Kernel 11: blockwise key-masked attention with an online softmax (flash
// attention), eval forward.
//
// Replaces: multimodal_transformer_tpu/ops/pallas/attention.py
//   flash_attention_masked (body _kernel), which is also the forward of
//   flash_attention_trainable.
//
// q, k, v [BH, T, DK] (batch x heads flattened), kmask [BH / h, Tk] fp32 (the
// mask of video bh / h, so the repeat over heads is never materialised):
//   q'      = q * scale, rounded to the storage dtype (scale = 1/sqrt(DK),
//             itself rounded to the storage dtype by the caller)
//   s[i, j] = q'[i] . k[j] in fp32, or -1e9 where kmask[j] == 0
//   out[i]  = sum_j softmax_j(s[i]) v[j], rounded to the storage dtype
// Query rows are not masked.  A row whose keys are all masked stays finite:
// every key scores -1e9 and the row is the uniform mean of v, as in the
// dense function.  Keys past Tk are excluded exactly (the TPU kernel padded
// them to its block and masked them, which changes only all-masked rows).
// The running max and sum are fp32 (the max starts at -1e9, as there), and
// p @ v accumulates in fp32.
//
// What bounds it on the H100: at the long-video route's shapes (BH = 32 x 8,
// T = 544..1120, DK = 32) one call moves ~36-73 MB of bf16 q, k, v and out
// and does 4 BH T^2 DK = 9.7-41 GFLOP (14.6-62 with the split p below), so in
// bf16 it sits near the ridge of the bytes (~11-22 us), the tensor cores
// (~15-62 us) and the exponentials (one per score on the SFUs, ~20-85 us);
// in fp32 every product runs on the FMA pipes (67 TFLOP/s) and bounds it
// (~0.15-0.6 ms).  Measured on an H100, the bf16 path is held by its p.v:
// DK = 32 makes each p.v wgmma a small m64n32k16, and the split p needs 16
// of them per 128-key tile, which run far below the tensor cores' rate.
//
// Three paths, chosen by the wrapper from (dtype, DK) and checked here:
//   * bf16, DK in {16, 32} (the encoders' D = 256 at h = 8 is DK = 32): one
//     block per (bh, 128-query tile), three warpgroups.  Warpgroup 0 is the
//     producer: one thread loads each 128-key tile of K and V with TMA (3-D
//     tensor maps (DK, Tk, BH), box (DK, 128, 1), so a tile never crosses
//     into the next head; keys >= Tk are zero-filled by the hardware), and
//     its warp copies the tile's 128 mask values with 4-byte cp.async (the
//     [B, Tk] mask's rows are 16-byte multiples only when Tk % 4 == 0, and
//     T = 601's are not, so TMA cannot take them), into a 3-stage ring
//     tracked by a full and an empty mbarrier per stage: the full barrier
//     completes on the TMA's bytes and the warp's copies
//     (cp.async.mbarrier.arrive), so the producer never waits on a load;
//     `setmaxnreg` gives its registers to the consumers.
//     Warpgroups 1 and 2 consume 64 query rows each (a warpgroup whose rows
//     are all past Tq only frees the stages): s = q'.k^T on wgmma
//     m64n128k16 with q' in registers (RS) and K read K-major from the
//     swizzled tile; each warp turns the mask tile into bit words with
//     ballots; the online softmax runs on the accumulator registers with
//     exp2 of s log2(e) - m log2(e); o += p.v on wgmma m64n{DK}k16 with V
//     read MN-major (the transpose bit), where the score accumulators are
//     exactly the A fragments of p.  Tile i's scores and tile i - 1's p.v
//     are issued together, and p.v runs while tile i's softmax does (two
//     score buffers); the two consumers take turns to issue them (named
//     barriers), so one's softmax runs while the other's products do.  The TPU kernel keeps p in fp32 for p @ v; here
//     p = hi + lo with hi and lo bf16 (a split-bf16 product, two wgmma per
//     k step): v is bf16 already, so each product is exact to ~2^-17 of p,
//     far inside the output's bf16 rounding (2^-9).  A consumer warp frees
//     a stage once its wgmmas on it have completed.  The output leaves
//     through shared memory as 16-byte rows.
//   * bf16, DK in {2, 4, 8} (the emotient encoder, D = 16): a row is under
//     TMA's 16-byte minimum and wgmma's k depth, so one block per (bh,
//     64-query tile) of 4 warps of 16 rows; 64-key tiles of k, v and the
//     mask double buffered with cp.async, zero-padded to one k step of 16;
//     q.k^T and the split-bf16 p.v on mma.sync m16n8k16.
//   * fp32: 4 threads share a query row; each scores every fourth key of a
//     64-key tile (cp.async, double buffered) and keeps its own partial
//     p @ v over its keys (float4 reads of shared memory, conflict-free row
//     stride DK + 4), and the four partial sums are joined by shuffles at
//     the end, so no p tile is stored.

#include "hopper.cuh"

namespace mmtx {
namespace flash {

constexpr float kMaskedScore = -1e9f;
constexpr int QT = 64, KT = 64;  // query rows per block, keys per tile
constexpr int kThreads16 = 128;  // bf16: 4 warps x 16 query rows
constexpr int TPQ = 4;           // fp32: threads per query row
constexpr int kThreads32 = QT * TPQ;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two bf16 values into one register, the lower column in the low half.
__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// (x, y) = hi + lo with hi = bf16(x, y) and lo the bf16 of the remainder.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// The key loop of a block: tile i + 1's copies are in flight while tile i
// is computed.  load(buf, k0) issues the copies of the tile at key k0 into
// buffer buf; compute(buf, k0) consumes it.
template <typename Load, typename Compute>
__device__ __forceinline__ void key_tiles(int Tk, Load load, Compute compute) {
  const int n = (Tk + KT - 1) / KT;
  load(0, 0);
  cp_async_commit();
  for (int i = 0; i < n; ++i) {
    cp_async_wait<0>();
    __syncthreads();  // tile i has landed for every thread; tile i - 1 is free
    if (i + 1 < n) load((i + 1) & 1, (i + 1) * KT);
    cp_async_commit();
    compute(i & 1, i * KT);
  }
  cp_async_wait<0>();
}

template <int DK>
__global__ void __launch_bounds__(kThreads16)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ kmask,
                  bf16* __restrict__ out, int Tq, int Tk, int h, float scale) {
  constexpr int DKP = DK < 16 ? 16 : DK;  // depth of q.k, zero-padded
  constexpr int LD = DKP + 8;             // row stride: 16-byte rows, no bank conflicts
  constexpr int KS = DKP / 16;            // k steps of q.k
  constexpr int NO = (DK + 7) / 8;        // 8-column tiles of the output
  constexpr int CH = DK * 2 < 16 ? DK * 2 : 16;  // bytes per copy
  constexpr int CPR = DK * 2 / CH;               // copies per row
  __shared__ __align__(16) bf16 Ks[2][KT][LD];
  __shared__ __align__(16) bf16 Vs[2][KT][LD];
  __shared__ __align__(16) float Ms[2][KT];

  const int bh = blockIdx.y, q0 = blockIdx.x * QT;
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* kb = k + (size_t)bh * Tk * DK;
  const bf16* vb = v + (size_t)bh * Tk * DK;
  const float* km = kmask + (size_t)(bh / h) * Tk;

  if constexpr (DK < DKP) {  // the padding columns: zero once, no copy writes them
    bf16* ks = &Ks[0][0][0];
    bf16* vs = &Vs[0][0][0];
    for (int i = tid; i < 2 * KT * LD; i += kThreads16) {
      ks[i] = __float2bfloat16_rn(0.f);
      vs[i] = __float2bfloat16_rn(0.f);
    }
    __syncthreads();
  }

  // q' fragments of the warp's 16 rows (A operand, row major)
  const int r0 = q0 + (tid >> 5) * 16 + g, r1 = r0 + 8;
  const bf16* qb = q + (size_t)bh * Tq * DK;
  auto qv = [&](int r, int d) -> float {
    if (r >= Tq || d >= DK) return 0.f;
    return __bfloat162float(__float2bfloat16_rn(__bfloat162float(qb[(size_t)r * DK + d]) * scale));
  };
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int c = ks * 16 + 2 * t;
    qa[ks][0] = as_u32(__floats2bfloat162_rn(qv(r0, c), qv(r0, c + 1)));
    qa[ks][1] = as_u32(__floats2bfloat162_rn(qv(r1, c), qv(r1, c + 1)));
    qa[ks][2] = as_u32(__floats2bfloat162_rn(qv(r0, c + 8), qv(r0, c + 9)));
    qa[ks][3] = as_u32(__floats2bfloat162_rn(qv(r1, c + 8), qv(r1, c + 9)));
  }

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kMaskedScore, m1 = kMaskedScore, l0 = 0.f, l1 = 0.f;

  auto load = [&](int buf, int k0) {
    for (int i = tid; i < KT * CPR; i += kThreads16) {
      const int j = i / CPR, c = (i % CPR) * (CH / 2);
      const bool ok = k0 + j < Tk;
      const size_t off = (size_t)(ok ? k0 + j : 0) * DK + c;
      cp_async<CH>(&Ks[buf][j][c], kb + off, ok);
      cp_async<CH>(&Vs[buf][j][c], vb + off, ok);
    }
    for (int j = tid; j < KT; j += kThreads16) {
      const bool ok = k0 + j < Tk;
      cp_async<4>(&Ms[buf][j], km + (ok ? k0 + j : 0), ok);
    }
  };

  auto compute = [&](int buf, int k0) {
    // s = q' k^T: 8 tiles of 8 keys; thread holds rows g, g + 8 and keys
    // 8n + 2t, 8n + 2t + 1 of each
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const bf16* kr = &Ks[buf][8 * n + g][ks * 16 + 2 * t];
        const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(kr),
                               *reinterpret_cast<const uint32_t*>(kr + 8)};
        mma_bf16(s[n], qa[ks], b);
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 8 * n + 2 * t + e;
        if (k0 + j >= Tk) {
          s[n][e] = s[n][2 + e] = -INFINITY;
        } else if (Ms[buf][j] == 0.f) {
          s[n][e] = s[n][2 + e] = kMaskedScore;
        }
        mx0 = fmaxf(mx0, s[n][e]);
        mx1 = fmaxf(mx1, s[n][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // the 4 threads of a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // every tile holds a key < Tk, so mx >= -1e9 and the new max is finite
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[n][e] = expf(s[n][e] - m0);
        s[n][2 + e] = expf(s[n][2 + e] - m1);
        l0 += s[n][e];
        l1 += s[n][2 + e];
      }
    }
    // o += p v over 4 steps of 16 keys; the score tiles 2kk and 2kk + 1 are
    // the A fragment of step kk
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
      const int j = 16 * kk + 2 * t;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int col = 8 * n + g;
        const uint32_t b[2] = {pack2(Vs[buf][j][col], Vs[buf][j + 1][col]),
                               pack2(Vs[buf][j + 8][col], Vs[buf][j + 9][col])};
        mma_bf16(o[n], ph, b);
        mma_bf16(o[n], pl, b);
      }
    }
  };

  key_tiles(Tk, load, compute);

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  bf16* ob = out + (size_t)bh * Tq * DK;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * n + 2 * t + e;
      if (col >= DK) continue;
      if (r0 < Tq) ob[(size_t)r0 * DK + col] = __float2bfloat16_rn(o[n][e] / l0);
      if (r1 < Tq) ob[(size_t)r1 * DK + col] = __float2bfloat16_rn(o[n][2 + e] / l1);
    }
  }
}

template <int DK>
__global__ void __launch_bounds__(kThreads32)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ kmask,
                 float* __restrict__ out, int Tq, int Tk, int h, float scale) {
  constexpr int LD = DK < 4 ? 4 : DK + 4;  // floats: 16-byte rows, no bank conflicts
  constexpr int VW = DK < 4 ? 2 : 4;       // floats per shared-memory read
  constexpr int CH = DK * 4 < 16 ? DK * 4 : 16;
  constexpr int CPR = DK * 4 / CH;
  constexpr int KPT = KT / TPQ;
  __shared__ __align__(16) float Ks[2][KT][LD];
  __shared__ __align__(16) float Vs[2][KT][LD];
  __shared__ __align__(16) float Ms[2][KT];

  const int bh = blockIdx.y, tid = threadIdx.x;
  const int sub = tid % TPQ, qi = blockIdx.x * QT + tid / TPQ;
  const float* kb = k + (size_t)bh * Tk * DK;
  const float* vb = v + (size_t)bh * Tk * DK;
  const float* km = kmask + (size_t)(bh / h) * Tk;

  float qr[DK], acc[DK];
#pragma unroll
  for (int d = 0; d < DK; ++d) {
    qr[d] = qi < Tq ? q[((size_t)bh * Tq + qi) * DK + d] * scale : 0.f;
    acc[d] = 0.f;
  }
  float m = kMaskedScore, l = 0.f;

  auto load = [&](int buf, int k0) {
    for (int i = tid; i < KT * CPR; i += kThreads32) {
      const int j = i / CPR, c = (i % CPR) * (CH / 4);
      const bool ok = k0 + j < Tk;
      const size_t off = (size_t)(ok ? k0 + j : 0) * DK + c;
      cp_async<CH>(&Ks[buf][j][c], kb + off, ok);
      cp_async<CH>(&Vs[buf][j][c], vb + off, ok);
    }
    for (int j = tid; j < KT; j += kThreads32) {
      const bool ok = k0 + j < Tk;
      cp_async<4>(&Ms[buf][j], km + (ok ? k0 + j : 0), ok);
    }
  };

  auto compute = [&](int buf, int k0) {
    float s[KPT];
    float mx = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const int j = jj * TPQ + sub;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < DK; d += VW) {
        if constexpr (VW == 4) {
          const float4 kv = *reinterpret_cast<const float4*>(&Ks[buf][j][d]);
          dot = fmaf(qr[d], kv.x, dot);
          dot = fmaf(qr[d + 1], kv.y, dot);
          dot = fmaf(qr[d + 2], kv.z, dot);
          dot = fmaf(qr[d + 3], kv.w, dot);
        } else {
          const float2 kv = *reinterpret_cast<const float2*>(&Ks[buf][j][d]);
          dot = fmaf(qr[d], kv.x, dot);
          dot = fmaf(qr[d + 1], kv.y, dot);
        }
      }
      s[jj] = k0 + j >= Tk ? -INFINITY : (Ms[buf][j] == 0.f ? kMaskedScore : dot);
      mx = fmaxf(mx, s[jj]);
    }
#pragma unroll
    for (int off = 1; off < TPQ; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float mn = fmaxf(m, mx);
    const float a = expf(m - mn);
    m = mn;
    l *= a;
#pragma unroll
    for (int d = 0; d < DK; ++d) acc[d] *= a;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const int j = jj * TPQ + sub;
      const float p = expf(s[jj] - m);
      l += p;
#pragma unroll
      for (int d = 0; d < DK; d += VW) {
        if constexpr (VW == 4) {
          const float4 vv = *reinterpret_cast<const float4*>(&Vs[buf][j][d]);
          acc[d] = fmaf(p, vv.x, acc[d]);
          acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
          acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
          acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
        } else {
          const float2 vv = *reinterpret_cast<const float2*>(&Vs[buf][j][d]);
          acc[d] = fmaf(p, vv.x, acc[d]);
          acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
        }
      }
    }
  };

  key_tiles(Tk, load, compute);

  // join the 4 partial sums of the row (same running max in all 4)
#pragma unroll
  for (int off = 1; off < TPQ; off <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
    for (int d = 0; d < DK; ++d) acc[d] += __shfl_xor_sync(0xffffffffu, acc[d], off);
  }
  if (qi < Tq) {
    float* o = out + ((size_t)bh * Tq + qi) * DK;
#pragma unroll
    for (int d = 0; d < DK; ++d)
      if (d % TPQ == sub) o[d] = acc[d] / l;
  }
}

// ---------------------------------------------------------------------------
// bf16, DK in {16, 32}: TMA into an mbarrier ring, both products on wgmma.

namespace hopper {

using namespace ::mmtx::sm90;

constexpr int kConsumers = 2;                 // warpgroups of 64 query rows
constexpr int QT = 64 * kConsumers, KT = 128;  // query rows per block, keys per tile
constexpr int STAGES = 3;                     // K/V tiles in flight
constexpr int kThreads = 128 * (1 + kConsumers);  // warpgroup 0 produces
// 128 * 40 + 256 * 232 = 384 * 168, the registers of the block at entry
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, from a 1024-byte aligned base: K tiles, V tiles (each
// 128 rows of DK bf16, swizzled over the row's 32 or 64 bytes, as TMA
// writes them and wgmma reads them), the consumers' output staging, the
// mask tiles (128 fp32 each) and the barriers (full[STAGES],
// empty[STAGES]).
template <int DK>
struct Layout {
  static constexpr int kRowBytes = DK * 2;           // the swizzle span
  static constexpr int kGroupBytes = 8 * kRowBytes;  // 8 rows: the descriptors' stride
  static constexpr int kTileBytes = KT * kRowBytes;
  static constexpr int kOutLd = kRowBytes + 16;      // staging row stride, no bank conflicts
  static constexpr int kK = 0;
  static constexpr int kV = STAGES * kTileBytes;
  static constexpr int kOut = 2 * STAGES * kTileBytes;
  static constexpr int kMask = kOut + kConsumers * 64 * kOutLd;
  static constexpr int kMaskBytes = KT * 4;
  static constexpr int kBar = kMask + STAGES * kMaskBytes;
  static constexpr int kDynamic = kBar + 2 * STAGES * 8 + 1024;  // + alignment slack
  static constexpr uint64_t kSwizzle = DK == 32 ? 2 : 3;  // descriptor mode: 64B or 32B
};

template <int DK>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tmk,
                   const __grid_constant__ CUtensorMap tmv, const bf16* __restrict__ q,
                   const float* __restrict__ kmask, bf16* __restrict__ out, int Tq,
                   int Tk, int h, float scale) {
  using L = Layout<DK>;
  constexpr int KS = DK / 16;  // k steps of q.k^T
  constexpr int NO = DK / 2;   // output accumulators per thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  float* masks = reinterpret_cast<float*>(smem + L::kMask);
  const uint32_t full0 = base + L::kBar, empty0 = full0 + 8 * STAGES;

  const int bh = blockIdx.y, q0 = blockIdx.x * QT;
  const int n = (Tk + KT - 1) / KT;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 33);    // the TMA's bytes, the 32 lanes' copies
      mbar_init(empty0 + 8 * s, 4 * kConsumers);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one warp loads, the other three leave
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (warp != 0) return;
    const float* km = kmask + (size_t)(bh / h) * Tk;
    for (int i = 0; i < n; ++i) {
      const int s = i % STAGES, k0 = i * KT;
      const uint32_t full = full0 + 8 * s;
      mbar_wait(empty0 + 8 * s, ((i / STAGES) & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_tx(full, 2 * L::kTileBytes);
        tma_load(base + L::kK + s * L::kTileBytes, &tmk, 0, k0, bh, full);
        tma_load(base + L::kV + s * L::kTileBytes, &tmv, 0, k0, bh, full);
      }
#pragma unroll
      for (int w = 0; w < 4; ++w) {  // zeros past Tk
        const int key = k0 + 32 * w + lane;
        cp_async<4>(masks + s * KT + 32 * w + lane, km + (key < Tk ? key : 0), key < Tk);
      }
      mbar_arrive_cp_async(full);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
  const int c = wg - 1;
  auto release = [&](int i) {  // this warp is done with tile i's stage
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * (i % STAGES));
  };
  if (q0 + 64 * c >= Tq) {
    // every row of this warpgroup is past Tq (the last query tile of a
    // ragged T): free each stage once it has filled, compute nothing
    for (int i = 0; i < n; ++i) {
      mbar_wait(full0 + 8 * (i % STAGES), (i / STAGES) & 1);
      release(i);
    }
    return;
  }
  const int g = lane >> 2, t = lane & 3;
  const int lr = 64 * c + 16 * warp + g;  // the thread's first row in the block
  const int r0 = q0 + lr, r1 = r0 + 8;

  // q' fragments (the A operand of q.k^T in registers): rows r0 and r1,
  // columns 16 ks + 2t, + 1, + 8, + 9
  const bf16* qb = q + (size_t)bh * Tq * DK;
  auto qpair = [&](int r, int col) -> uint32_t {
    if (r >= Tq) return 0u;
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(qb + (size_t)r * DK + col));
    return as_u32(__floats2bfloat162_rn(f.x * scale, f.y * scale));
  };
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int col = 16 * ks + 2 * t;
    qa[ks][0] = qpair(r0, col);
    qa[ks][1] = qpair(r1, col);
    qa[ks][2] = qpair(r0, col + 8);
    qa[ks][3] = qpair(r1, col + 8);
  }

  // Two score tiles (one being scored while the other's p is multiplied by
  // V): s[4j + e] is row g, s[4j + 2 + e] row g + 8 (of the warp's 16) at
  // key 8j + 2t + e; o the same over the DK columns.
  float sa[64], sb[64], o[NO];
#pragma unroll
  for (int i = 0; i < 64; ++i) sa[i] = sb[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m0 = kMaskedScore, m1 = kMaskedScore, l0 = 0.f, l1 = 0.f;

  // s = q' K_i^T (one commit group)
  auto issue_scores = [&](float (&s)[64], int i) {
    const uint32_t kt = base + L::kK + (i % STAGES) * L::kTileBytes;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wgmma_n128(s, qa[ks], smem_desc(kt + 32 * ks, L::kGroupBytes, L::kSwizzle), ks);
    wg_commit();
  };
  // o += p V_i over 8 steps of 16 keys, p's (hi, lo) pairs in place of the
  // scores: score tiles 2kk and 2kk + 1 are the A fragment of step kk (one
  // commit group)
  auto issue_pv = [&](float (&p)[64], int i) {
    const uint32_t vt = base + L::kV + (i % STAGES) * L::kTileBytes;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const float* f = p + 8 * kk;
      const uint32_t ph[4] = {__float_as_uint(f[0]), __float_as_uint(f[2]),
                              __float_as_uint(f[4]), __float_as_uint(f[6])};
      const uint32_t pl[4] = {__float_as_uint(f[1]), __float_as_uint(f[3]),
                              __float_as_uint(f[5]), __float_as_uint(f[7])};
      const uint64_t dv = smem_desc(vt + 16 * kk * L::kRowBytes, L::kGroupBytes, L::kSwizzle);
      wgmma_pv<DK>(o, ph, dv);
      wgmma_pv<DK>(o, pl, dv);
    }
    wg_commit();
  };
  // The online softmax of tile i on its scores, in place: the mask, the new
  // running max, p = 2^(s log2 e - m log2 e) (one FFMA and one MUFU.EX2 a
  // score; a row whose keys are all masked gets one power of two for every
  // key, so it stays the uniform mean), the running sum, and each pair
  // (s[2i], s[2i + 1]) turned into the bf16 pairs (hi, lo) of p = hi + lo.
  // Returns in a0, a1 the factors of the rows' earlier sums.
  auto softmax = [&](float (&s)[64], int i, float& a0, float& a1) {
    // the tile's keys as bit words (key 32w + b is bit b of word w): kept
    // (in range, mask != 0) and in range
    const float* mt = masks + (i % STAGES) * KT;
    const int live = Tk - i * KT;
    uint32_t kw[4], lw[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const bool in = 32 * w + lane < live;
      kw[w] = __ballot_sync(0xffffffffu, in && mt[32 * w + lane] != 0.f);
      lw[w] = __ballot_sync(0xffffffffu, in);
    }
    if ((kw[0] & kw[1] & kw[2] & kw[3]) != 0xffffffffu) {  // a key masked or past Tk
      uint32_t kb[4], lb[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        kb[w] = kw[w] >> (2 * t);
        lb[w] = lw[w] >> (2 * t);
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int bit = 8 * (j & 3) + e;
          if (!((kb[j >> 2] >> bit) & 1u)) {
            const float fill = ((lb[j >> 2] >> bit) & 1u) ? kMaskedScore : -INFINITY;
            s[4 * j + e] = fill;
            s[4 * j + 2 + e] = fill;
          }
        }
      }
    }
    float x0[8], x1[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      x0[j] = fmaxf(fmaxf(s[8 * j], s[8 * j + 1]), fmaxf(s[8 * j + 4], s[8 * j + 5]));
      x1[j] = fmaxf(fmaxf(s[8 * j + 2], s[8 * j + 3]), fmaxf(s[8 * j + 6], s[8 * j + 7]));
    }
#pragma unroll
    for (int w = 4; w > 0; w >>= 1) {
#pragma unroll
      for (int j = 0; j < w; ++j) {
        x0[j] = fmaxf(x0[j], x0[j + w]);
        x1[j] = fmaxf(x1[j], x1[j + w]);
      }
    }
    float mx0 = x0[0], mx1 = x1[0];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // the 4 threads of a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // every tile holds a key < Tk, so mx >= -1e9 and the new max is finite
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    a0 = ex2((m0 - mn0) * kLog2e);
    a1 = ex2((m1 - mn1) * kLog2e);
    m0 = mn0;
    m1 = mn1;
    const float ml0 = mn0 * kLog2e, ml1 = mn1 * kLog2e;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float p0 = ex2(fmaf(s[4 * j], kLog2e, -ml0));
      const float p1 = ex2(fmaf(s[4 * j + 1], kLog2e, -ml0));
      const float p2 = ex2(fmaf(s[4 * j + 2], kLog2e, -ml1));
      const float p3 = ex2(fmaf(s[4 * j + 3], kLog2e, -ml1));
      sum0 += p0 + p1;
      sum1 += p2 + p3;
      uint32_t hi, lo;
      split_bf16(p0, p1, hi, lo);
      s[4 * j] = __uint_as_float(hi);
      s[4 * j + 1] = __uint_as_float(lo);
      split_bf16(p2, p3, hi, lo);
      s[4 * j + 2] = __uint_as_float(hi);
      s[4 * j + 3] = __uint_as_float(lo);
    }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
  };

  // The consumers take turns to issue their wgmmas (barrier 1 + c is
  // consumer c's turn), so one's softmax runs while the other's products
  // do; without the turns both would wait on the same stage, multiply
  // together, then take their exponentials together.  Each issues n + 1
  // times; a block whose second consumer has no rows takes no turns.
  const bool turns = kConsumers == 2 && q0 + 64 < Tq;
  auto my_turn = [&]() {
    if (turns) bar_sync(1 + c, 256);
  };
  auto your_turn = [&]() {
    if (turns) bar_arrive(2 - c, 256);
  };
  if (c == 1) your_turn();  // consumer 0 goes first

  // tile 0
  float a0, a1;
  mbar_wait(full0, 0);
  my_turn();
  wg_fence();
  issue_scores(sa, 0);
  your_turn();
  wg_wait<0>();
  fence_regs(sa);
  softmax(sa, 0, a0, a1);  // o is still 0
  // tile i: its scores and tile i - 1's p V in flight together, then its
  // softmax while p V runs, then o rescaled to the new max
  auto step = [&](float (&s)[64], float (&p)[64], int i) {
    mbar_wait(full0 + 8 * (i % STAGES), (i / STAGES) & 1);
    my_turn();
    wg_fence();
    issue_scores(s, i);
    issue_pv(p, i - 1);
    your_turn();
    wg_wait<1>();
    fence_regs(s);
    float b0, b1;
    softmax(s, i, b0, b1);
    wg_wait<0>();
    fence_regs(o);
    fence_regs(p);
    release(i - 1);
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      o[4 * j] *= b0;
      o[4 * j + 1] *= b0;
      o[4 * j + 2] *= b1;
      o[4 * j + 3] *= b1;
    }
  };
  auto last_pv = [&](float (&p)[64]) {
    my_turn();
    wg_fence();
    issue_pv(p, n - 1);
    your_turn();
    wg_wait<0>();
    fence_regs(o);
    release(n - 1);
  };
  int i = 1;
  for (; i + 1 < n; i += 2) {  // two tiles an iteration: the buffers trade roles
    step(sb, sa, i);
    step(sa, sb, i + 1);
  }
  if (i < n) {
    step(sb, sa, i);
    last_pv(sb);
  } else {
    last_pv(sa);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  // through the warp's 16 staging rows, then 16-byte rows to global memory
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  uint8_t* stage_out = smem + L::kOut;
#pragma unroll
  for (int j = 0; j < NO / 4; ++j) {
    const int col = 8 * j + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(stage_out + lr * L::kOutLd + 2 * col) =
        __floats2bfloat162_rn(o[4 * j] * i0, o[4 * j + 1] * i0);
    *reinterpret_cast<__nv_bfloat162*>(stage_out + (lr + 8) * L::kOutLd + 2 * col) =
        __floats2bfloat162_rn(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
  }
  __syncwarp();
  constexpr int CPR = L::kRowBytes / 16;  // 16-byte chunks per row
  const int wr = 64 * c + 16 * warp;      // the warp's first row in the block
#pragma unroll
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int rr = i / CPR, ch = i % CPR;
    const int row = q0 + wr + rr;
    if (row < Tq)
      *reinterpret_cast<uint4*>(out + ((size_t)bh * Tq + row) * DK + 8 * ch) =
          *reinterpret_cast<const uint4*>(stage_out + (wr + rr) * L::kOutLd + 16 * ch);
  }
}

}  // namespace hopper

// The map of a [BH, Tk, DK] bf16 tensor, dims innermost first, one box a
// 128-key tile of one head, swizzled over its DK * 2-byte rows.
template <int DK>
bool tensor_map(CUtensorMap* map, const void* t, int BH, int Tk) {
  const sm90::EncodeTiled fn = sm90::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)DK, (cuuint64_t)Tk, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)DK * 2, (cuuint64_t)Tk * DK * 2};
  const cuuint32_t box[3] = {(cuuint32_t)DK, (cuuint32_t)hopper::KT, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(t), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            DK == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DK>
int launch_hopper(const void* q, const void* k, const void* v, const float* km, void* out,
                  int BH, int Tq, int Tk, int h, float scale, cudaStream_t st) {
  using L = hopper::Layout<DK>;
  const auto kernel = hopper::flash_wgmma_kernel<DK>;
  static int setup = -1;  // cudaError_t of the one-time set-up
  if (setup < 0) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kDynamic);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    // setmaxnreg.inc waits for registers the producer released: the block
    // must start with all of them, or the consumers would wait forever
    if (err == cudaSuccess &&
        attr.numRegs * hopper::kThreads <
            128 * (hopper::kProducerRegs + hopper::kConsumers * hopper::kConsumerRegs))
      err = cudaErrorInvalidConfiguration;
    setup = (int)err;
  }
  if (setup != 0) return setup;
  CUtensorMap tmk, tmv;
  if (!tensor_map<DK>(&tmk, k, BH, Tk) || !tensor_map<DK>(&tmv, v, BH, Tk))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Tq + hopper::QT - 1) / hopper::QT, BH);
  kernel<<<grid, hopper::kThreads, L::kDynamic, st>>>(
      tmk, tmv, static_cast<const bf16*>(q), km, static_cast<bf16*>(out), Tq, Tk, h, scale);
  return (int)cudaGetLastError();
}

enum Path : int { kPathFma = 0, kPathMma = 1, kPathWgmma = 2 };

template <int DK>
int launch(int path, const void* q, const void* k, const void* v, const float* km,
           void* out, int BH, int Tq, int Tk, int h, float scale, cudaStream_t st) {
  const dim3 grid((Tq + QT - 1) / QT, BH);
  if (path == kPathWgmma) {
    if constexpr (DK >= 16) {
      return launch_hopper<DK>(q, k, v, km, out, BH, Tq, Tk, h, scale, st);
    }
  } else if (path == kPathMma) {
    if constexpr (DK < 16) {
      flash_bf16_kernel<DK><<<grid, kThreads16, 0, st>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), km, static_cast<bf16*>(out), Tq, Tk, h, scale);
      return (int)cudaGetLastError();
    }
  } else {
    flash_f32_kernel<DK><<<grid, kThreads32, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), km, static_cast<float*>(out), Tq, Tk, h, scale);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace flash
}  // namespace mmtx

// C entry.  path: 0 fp32 (FMA pipes), 1 bf16 with DK < 16 (mma.sync), 2 bf16
// with DK in {16, 32} (TMA + wgmma); it must be the one of (dtype, DK), as
// the wrapper's kernel_path chooses it.  q/out [BH, Tq, DK], k/v [BH, Tk, DK],
// all contiguous and 16-byte aligned, in the storage dtype (0 fp32, 1 bf16);
// kmask [BH / h, Tk] fp32; scale: 1/sqrt(DK) rounded to the storage dtype.
// Returns cudaGetLastError() after the launch, or the error of a set-up step.
extern "C" int mmtx_flash_attention(int path, int dtype, const void* q, const void* k,
                                    const void* v, const void* kmask, void* out,
                                    int BH, int Tq, int Tk, int DK, int h, float scale,
                                    void* stream) {
  using namespace mmtx;
  using namespace mmtx::flash;
  if ((dtype != kF32 && dtype != kBF16) || BH < 1 || Tq < 1 || Tk < 1 || h < 1 ||
      BH % h != 0)
    return (int)cudaErrorInvalidValue;
  const int want = dtype == kF32 ? kPathFma : (DK >= 16 ? kPathWgmma : kPathMma);
  if (path != want) return (int)cudaErrorInvalidValue;
  const float* km = static_cast<const float*>(kmask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (DK) {
    case 2: return launch<2>(path, q, k, v, km, out, BH, Tq, Tk, h, scale, st);
    case 4: return launch<4>(path, q, k, v, km, out, BH, Tq, Tk, h, scale, st);
    case 8: return launch<8>(path, q, k, v, km, out, BH, Tq, Tk, h, scale, st);
    case 16: return launch<16>(path, q, k, v, km, out, BH, Tq, Tk, h, scale, st);
    case 32: return launch<32>(path, q, k, v, km, out, BH, Tq, Tk, h, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
