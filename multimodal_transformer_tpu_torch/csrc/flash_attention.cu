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
// and does 4 BH T^2 DK = 9.7-41 GFLOP, so in bf16 it sits at the ridge of
// the bytes (~11-22 us) and the tensor cores (~10-42 us); in fp32 every
// product runs on the FMA pipes (67 TFLOP/s) and bounds it (~0.15-0.6 ms).
//
// What the design does about it, simple first (no wgmma, no TMA):
//   * One block per (bh, 64-query tile); the key loop runs inside the block
//     over 64-key tiles of k, v and the mask in shared memory, double
//     buffered with cp.async (the copy of tile i + 1 in flight while tile i
//     is multiplied); the ragged key tail is zero-filled by the copy and
//     excluded in the softmax.  Nothing quadratic in T touches memory.
//   * bf16: 4 warps of 16 query rows each.  q.k^T runs on the tensor cores
//     (mma.sync m16n8k16, fp32 accumulation: exact products summed in fp32,
//     as the TPU kernel's preferred_element_type); the scores stay in the
//     accumulator registers, which are exactly the A fragments of p @ v.  The
//     TPU kernel keeps p in fp32 for p @ v; here p = hi + lo with hi and lo
//     bf16 (a split-bf16 product, two mma.sync per fragment): v is bf16
//     already, so each product is exact to ~2^-17 of p, far inside the
//     output's bf16 rounding (2^-9), and p @ v stays on the tensor cores.
//     DK < 16 is zero-padded to one k step of 16 in shared memory.
//   * fp32: 4 threads share a query row; each scores every fourth key of a
//     tile and keeps its own partial p @ v over its keys (float4 reads of
//     shared memory, conflict-free row stride DK + 4), and the four partial
//     sums are joined by shuffles at the end, so no p tile is stored.

#include "common.cuh"

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

template <int DK>
void launch(int dtype, const void* q, const void* k, const void* v, const float* km,
            void* out, int BH, int Tq, int Tk, int h, float scale, cudaStream_t st) {
  const dim3 grid((Tq + QT - 1) / QT, BH);
  if (dtype == kBF16) {
    flash_bf16_kernel<DK><<<grid, kThreads16, 0, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), km, static_cast<bf16*>(out), Tq, Tk, h, scale);
  } else {
    flash_f32_kernel<DK><<<grid, kThreads32, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), km, static_cast<float*>(out), Tq, Tk, h, scale);
  }
}

}  // namespace flash
}  // namespace mmtx

// C entry.  q/out [BH, Tq, DK], k/v [BH, Tk, DK], all contiguous and 16-byte
// aligned, in the storage dtype (0 fp32, 1 bf16); kmask [BH / h, Tk] fp32;
// scale: 1/sqrt(DK) rounded to the storage dtype.  Returns
// cudaGetLastError() after the launch.
extern "C" int mmtx_flash_attention(int dtype, const void* q, const void* k,
                                    const void* v, const void* kmask, void* out,
                                    int BH, int Tq, int Tk, int DK, int h, float scale,
                                    void* stream) {
  using namespace mmtx;
  if ((dtype != kF32 && dtype != kBF16) || BH < 1 || Tq < 1 || Tk < 1 || h < 1 ||
      BH % h != 0)
    return (int)cudaErrorInvalidValue;
  const float* km = static_cast<const float*>(kmask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (DK) {
    case 2: flash::launch<2>(dtype, q, k, v, km, out, BH, Tq, Tk, h, scale, st); break;
    case 4: flash::launch<4>(dtype, q, k, v, km, out, BH, Tq, Tk, h, scale, st); break;
    case 8: flash::launch<8>(dtype, q, k, v, km, out, BH, Tq, Tk, h, scale, st); break;
    case 16: flash::launch<16>(dtype, q, k, v, km, out, BH, Tq, Tk, h, scale, st); break;
    case 32: flash::launch<32>(dtype, q, k, v, km, out, BH, Tq, Tk, h, scale, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
