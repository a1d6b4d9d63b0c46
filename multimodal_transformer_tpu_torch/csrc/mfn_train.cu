// Kernels 6 and 7: the MFN recurrence's training forward (gamma-hidden hash
// dropout, every c_t saved) and its reverse-time backward.
//
// Replaces: multimodal_transformer_tpu/ops/pallas/mfn_train.py
//   kernel 6  _fwd_call (body _fwd_kernel);
//   kernel 7  _bwd_call (body _bwd_kernel).
//
// Kernel 6 is kernel B's three stages (csrc/mfn.cu, mfn_staged::launch):
// the LSTM scan also stores every c_t in the storage dtype beside h_t, and
// the memory scan drops the gamma1/gamma2 hiddens by the JAX package's
// fmix32 keep bit of position b * width + c under the step's seeds, hashed a
// step ahead of its use.  Its note there says what bounds it and why.
//
// Kernel 7 is five stages launched in order on one stream.  Only two
// quantities carry state backwards in time: the memory's cotangent (through
// the gamma MLPs' fc2 layers and the mem columns [2TH:] of their fc1
// layers) and the LSTM's (dh, dc) (through W_hh).  Everything else in a
// step depends on the saved states and on the memory's cotangent at that
// step, so it runs over all B*T rows at once:
//   S0 (recompute, batched): every row (b, t) rematerializes step t in fp32
//      from the saved t-1 states, read back in the storage dtype (zeros at
//      t = 0): z = xp + W_hh h_{t-1}, the cell (c_t recomputed, not read
//      back), att1 and the feature softmax, att2 and c^, the whole gamma fc1
//      (mem_{t-1} is saved) with its hash dropout, gamma1 and gamma2.  FMA
//      GEMMs with fused epilogues (mfn_staged.cuh ff_gemm_kernel) and
//      row-wise kernels; every layer input goes straight into X, the rows
//      the weight gradients read.
//   S1 (memory reverse scan): one block per video walks t down with the mem
//      columns of both gamma fc1 layers and both gamma fc2 layers, transposed,
//      in shared memory; a step is two barrier phases: dmem and the update's
//      backward (ds1, ds2, dc^), then the gamma hiddens' gradients (dp1, dp2).
//   S2 (the rest of the VJP, batched): dbpre = relu'(A2W2^T dc^), d attended
//      = A2W1^T dbpre + (the attended columns of both gamma fc1)^T [dp1; dp2]
//      in one product, the softmax's backward (dlog, d c*), dapre and
//      d c* += A1W1^T dapre.
//   S3 (LSTM reverse scan): one block per (video, modality) walks t down
//      with W_hh^T in shared memory; a step is one barrier phase: the cell's
//      backward gives dz (d_xp_t), then dh_{t-1} = W_hh^T dz.
//   S4 (parameter gradients): dW = G^T X over all B*T rows for all eleven
//      weights in one launch of 64x64 output tiles over fixed chunks of rows,
//      each bias read as a column of ones after its layer's input; a second
//      launch adds the chunks' partials in chunk order.
// Against the step-by-step order only the order of fp32 sums changes: gamma
// fc1's input gradient is split into its attended part (S2) and its mem part
// (S1), and the two products into d attended are one sum.
//
// What bounds it on the H100: the two scans are chains that no other work
// hides (one block per SM, T steps in series): shared-memory reads of the
// weights and of the broadcast vector, the shuffles that join a row's lanes,
// the barrier, and for S3 the cell's backward; about 1-2 us a step each.
// S0 and S2 hold most of the multiply-adds; they run on the fp32 FMA pipes
// (the activations are fp32, so bf16 tensor cores would add a rounding
// point the TPU kernel lacks) and are bound by their shared-memory reads.
// S4's products are large and parallel, bound like S0's by the FMA pipes'
// shared-memory reads.
//
// What the design does about it: the serial chains keep only the carries,
// with their weights in one SM's shared memory (opt-in past 48 KB) laid out
// so that each warp's weight reads are conflict-free, and each step's inputs
// (gates, saved states, cotangents, laid out per row by S0 and S2 as one
// record) arrive through cp.async into a ring, kRing - 1 steps ahead.  No
// float atomics: the same inputs give bit-identical gradients.

#include "mfn_staged.cuh"

namespace mmtx {
namespace mfnt {

using mfn::Args;
using mfn::kMaxMods;
using mfn_staged::dot4;
using mfn_staged::fma4;
using mfn_staged::ff_gemm;
using mfn_staged::FfJob;
using mfn_staged::gather;
using mfn_staged::kMaxThreads;
using mfn_staged::kRing;
using mfn_staged::kSmemMax;
using mfn_staged::lane_sums;
using mfn_staged::lanes_per_unit;
using mfn_staged::round_up;
using mfn_staged::to_f4;
using mfn_staged::Vec4;
using mfn_staged::zero_smem;

// Slots of the LSTM scan's per-row record L [B*T][kLSlots][TH]: the gates
// and tanh(c_t) of the recomputed step, c_{t-1}, the cotangent of h_t, and
// the gradient of c* = [c_{t-1}; c_t] (the last two slots, in c*'s order).
enum LSlot : int { kIg, kFg, kGg, kOg, kTc, kCprev, kGh, kDcPrev, kDcNew, kLSlots };
// Slots of the memory scan's per-row record MR [B*T][kMSlots][MEM].
enum MSlot : int { kGam1, kGam2, kChat, kMemPrev, kGm, kMSlots };

struct Widths {
  int TH, TH2, MEM, h1, h2, hg1, hg2, R, gin;
  // column offsets into X (the layer inputs of the weight gradients) and G
  // (the pre-activation gradients); [dbpre | dp1 | dp2] is contiguous, the
  // A operand of S2's d attended product
  int xo_hprev, xo_cstar, xo_ah, xo_both, xo_bh, xo_g1, xo_g2, XW;
  int go_dz, go_dapre, go_dlog, go_dchat, go_dbpre, go_dp1, go_dp2, go_ds1, go_ds2, GW;
  int LW, MW;  // row widths of the scans' records

  static Widths make(int TH, int MEM, int h1, int h2, int hg1, int hg2) {
    Widths w;
    w.TH = TH; w.TH2 = 2 * TH; w.MEM = MEM; w.h1 = h1; w.h2 = h2; w.hg1 = hg1; w.hg2 = hg2;
    w.R = hg1 + hg2;
    w.gin = 2 * TH + MEM;
    int o = 0;
    w.xo_hprev = o; o += TH;
    w.xo_cstar = o; o += 2 * TH;
    w.xo_ah = o; o += h1;
    w.xo_both = o; o += 2 * TH + MEM;
    w.xo_bh = o; o += h2;
    w.xo_g1 = o; o += hg1;
    w.xo_g2 = o; o += hg2;
    w.XW = o;
    o = 0;
    w.go_dz = o; o += 4 * TH;
    w.go_dapre = o; o += h1;
    w.go_dlog = o; o += 2 * TH;
    w.go_dchat = o; o += MEM;
    w.go_dbpre = o; o += h2;
    w.go_dp1 = o; o += hg1;
    w.go_dp2 = o; o += hg2;
    w.go_ds1 = o; o += MEM;
    w.go_ds2 = o; o += MEM;
    w.GW = o;
    w.LW = kLSlots * TH;
    w.MW = kMSlots * MEM;
    return w;
  }
};

struct BwdArgs {
  Args f;                    // shapes, xp, whh, gate weights, seeds, rates
  const void* hs;            // saved [B, T, TH] (storage dtype)
  const void* cs;
  const void* mems;          // [B, T, MEM]
  const float* g_hs;         // [B, T, TH]
  const float* g_mems;       // [B, T, MEM]
  void* dxp[kMaxMods];       // [B, T, 4H_m] (storage dtype)
  Widths w;
};

// ---------------------------------------------------------------- S0

struct PrepArgs {
  const void* hs;
  const void* cs;
  const void* mems;
  const float* g_hs;
  const float* g_mems;
  float *X, *L, *MR;
  int T;
  Widths w;
};

// Block per row (b, t): the saved t-1 states in fp32 (zeros at t = 0) into
// X and the scans' records, the cotangents of h_t and mem_t beside them.
template <typename T>
__global__ void prep_kernel(PrepArgs a) {
  const Widths& w = a.w;
  const size_t row = blockIdx.x;
  const bool first = row % a.T == 0;
  const T* hs = static_cast<const T*>(a.hs);
  const T* cs = static_cast<const T*>(a.cs);
  const T* mems = static_cast<const T*>(a.mems);
  float* X = a.X + row * w.XW;
  float* L = a.L + row * w.LW;
  float* MR = a.MR + row * w.MW;
  for (int i = threadIdx.x; i < w.TH; i += blockDim.x) {
    const float h = first ? 0.f : to_f(hs[(row - 1) * w.TH + i]);
    const float c = first ? 0.f : to_f(cs[(row - 1) * w.TH + i]);
    X[w.xo_hprev + i] = h;
    X[w.xo_cstar + i] = c;
    L[kCprev * w.TH + i] = c;
    L[kGh * w.TH + i] = a.g_hs[row * w.TH + i];
  }
  for (int i = threadIdx.x; i < w.MEM; i += blockDim.x) {
    const float m = first ? 0.f : to_f(mems[(row - 1) * w.MEM + i]);
    X[w.xo_both + w.TH2 + i] = m;
    MR[kMemPrev * w.MEM + i] = m;
    MR[kGm * w.MEM + i] = a.g_mems[row * w.MEM + i];
  }
}

// The GEMMs' epilogues (mfn_staged.cuh ff_gemm_kernel), row m, column n.
// z = acc + xp: the LSTM pre-activations on the hoisted input projection.
template <typename T>
struct AddXp {
  float* out;
  int ldo;
  const T* xp;
  int ldx;
  __device__ __forceinline__ void operator()(int m, int n, float acc) const {
    out[(size_t)m * ldo + n] = acc + to_f(xp[(size_t)m * ldx + n]);
  }
};

// out = act(acc + bias).
template <typename T>
struct Bias {
  float* out;
  int ldo;
  const T* bias;
  int act;
  __device__ __forceinline__ void operator()(int m, int n, float acc) const {
    out[(size_t)m * ldo + n] = mfn::activate(acc + to_f(bias[n]), act);
  }
};

// out = relu(acc + bias), dropped with the keep bit of position b * N + n
// under seeds[2 t + which], row m = b * steps + t.
template <typename T>
struct GammaDrop {
  float* out;
  int ldo;
  const T* bias;
  const uint32_t* seeds;
  int which, steps, N;
  uint32_t thr;
  float keep;
  __device__ __forceinline__ void operator()(int m, int n, float acc) const {
    const int b = m / steps, t = m - b * steps;
    const DropSite s{{seeds[2 * t + which], thr}, keep};
    out[(size_t)m * ldo + n] = s.apply(fmaxf(acc + to_f(bias[n]), 0.f), (uint32_t)(b * N + n));
  }
};

struct CellArgs {
  int hid[kMaxMods];
  const float* G;  // z in the dz columns
  float *X, *L;
  int M;
  Widths w;
};

// Thread per (row, unit): the gates from z, c_t = f c_{t-1} + i g recomputed
// in fp32 (into c*'s second half), tanh(c_t), into the LSTM scan's record.
__global__ void cell_kernel(CellArgs a) {
  const Widths& w = a.w;
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= (long long)a.M * w.TH) return;
  const size_t row = (size_t)(e / w.TH);
  const int i = (int)(e % w.TH);
  int m = 0, off = 0;
  while (i >= off + a.hid[m]) off += a.hid[m++];
  const int H = a.hid[m], j = i - off;
  const float* z = a.G + row * w.GW + w.go_dz + 4 * off;
  float* X = a.X + row * w.XW;
  float* L = a.L + row * w.LW;
  const float ig = sigmoidf(z[j]), fg = sigmoidf(z[H + j]);
  const float gg = tanhf(z[2 * H + j]), og = sigmoidf(z[3 * H + j]);
  const float c_new = fg * X[w.xo_cstar + i] + ig * gg;
  X[w.xo_cstar + w.TH + i] = c_new;
  L[kIg * w.TH + i] = ig;
  L[kFg * w.TH + i] = fg;
  L[kGg * w.TH + i] = gg;
  L[kOg * w.TH + i] = og;
  L[kTc * w.TH + i] = tanhf(c_new);
}

// One warp per row: att = softmax(logits) over the 2TH features, in place,
// and attended = att * c* into X.
__global__ void attend_kernel(float* __restrict__ att, float* __restrict__ X, int M, Widths w) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (row >= M) return;
  const int n = w.TH2;
  float* x = att + (size_t)row * n;
  float* xr = X + (size_t)row * w.XW;
  float mx = -INFINITY;
  for (int i = lane; i < n; i += 32) mx = fmaxf(mx, x[i]);
  mx = warp_max(mx);
  float sum = 0.f;
  for (int i = lane; i < n; i += 32) sum += expf(x[i] - mx);
  sum = warp_sum(sum);
  for (int i = lane; i < n; i += 32) {
    const float v = expf(x[i] - mx) / sum;
    x[i] = v;
    xr[w.xo_both + i] = v * xr[w.xo_cstar + i];
  }
}

// ---------------------------------------------------------------- S1

struct MemBwdArgs {
  const void* w1[2];  // gamma_k fc1 [hg_k, gin]; the columns [TH2:] are read
  const void* w2[2];  // gamma_k fc2 [MEM, hg_k]
  const float* MR;    // [B*T, MW]
  const float* X;     // the dropped gamma hiddens at xo_g1 (hg1, then hg2)
  float* G;
  float keep1, keep2;
  int T;
  Widths w;
};

// Shared memory of an S1 block, in bytes at the offsets: wa, the mem columns
// of both gamma fc1 layers transposed ([Rp/2/4][2 MEM lanes][4]: row r, the
// gamma hiddens in halves), and wb, both gamma fc2 layers transposed
// ([MEMp/2/4][2 R lanes][4]), in the storage dtype, zero past each row;
// then fp32 dp [Rp], ds [2][MEMp] and the ring of record rows [kRing][RW].
struct MemBwdLayout {
  int R, Rp, halfR, MEMp, halfM, RW;
  size_t wa, wb, dp, ds, ring, total;
  __host__ __device__ MemBwdLayout(int mem, int hg1, int hg2, size_t esize) {
    R = hg1 + hg2;
    Rp = round_up(R, 8);
    halfR = Rp / 2;
    MEMp = round_up(mem, 8);
    halfM = MEMp / 2;
    RW = kMSlots * mem + R;
    wa = 0;
    wb = wa + (size_t)mem * Rp * esize;
    dp = wb + (size_t)R * MEMp * esize;
    ds = dp + (size_t)Rp * sizeof(float);
    ring = ds + 2 * (size_t)MEMp * sizeof(float);
    total = ring + (size_t)kRing * RW * sizeof(float);
  }
};

inline int mem_bwd_threads(int mem, int R) { return round_up(2 * (mem > R ? mem : R), 32); }

// Block b: video b, t from T-1 down.  Phase 1, thread i = 2r + side (r <
// MEM): dmem[r] = dm_{t+1}[r] gamma1_{t+1}[r] + sum_k Wmem[k, r] dp_{t+1}[k],
// the side's half of k joined by a shuffle; then dm = g_mem + dmem and the
// update's backward (side 0: ds1, dc^; side 1: ds2).  Phase 2, thread i =
// 2k + side (k < hg1 + hg2): dhid[k] = fc2[:, k] . ds, dp[k] = hid > 0 ?
// dhid / keep_p : 0 (the dropped hidden is positive only where kept and
// ReLU passed).  Step t-1's record row arrives while step t computes.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads) mem_bwd_kernel(MemBwdArgs a) {
  using V = typename Vec4<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Widths& w = a.w;
  const int MEM = w.MEM, hg1 = w.hg1, TH2 = w.TH2, gin = w.gin;
  const MemBwdLayout L(MEM, hg1, w.hg2, sizeof(T));
  const int R = L.R, M2 = 2 * MEM, R2 = 2 * R, halfR = L.halfR, halfM = L.halfM;
  T* wa = reinterpret_cast<T*>(smem_raw + L.wa);
  T* wb = reinterpret_cast<T*>(smem_raw + L.wb);
  float* dps = reinterpret_cast<float*>(smem_raw + L.dp);
  float* dss = reinterpret_cast<float*>(smem_raw + L.ds);
  float* ring = reinterpret_cast<float*>(smem_raw + L.ring);
  const int b = blockIdx.x, tid = threadIdx.x, T_ = a.T;
  zero_smem(smem_raw, L.ring);
  __syncthreads();
  for (int g = 0; g < 2; ++g) {
    const int n = g ? w.hg2 : hg1, k0 = g ? hg1 : 0;
    // gamma_g fc1 row k, column TH2 + r -> row r of wa, lane 2 r + (k0 + k) / halfR
    gather(static_cast<const T*>(a.w1[g]), n * MEM, wa,
           [=](int e) { return (e / MEM) * gin + TH2 + e % MEM; },
           [=](int e) {
             const int k = k0 + e / MEM, r = e % MEM, kl = k % halfR;
             return ((kl >> 2) * M2 + 2 * r + k / halfR) * 4 + (kl & 3);
           });
    // gamma_g fc2 row r, column k -> row k0 + k of wb, lane 2 (k0 + k) + r / halfM
    gather(static_cast<const T*>(a.w2[g]), MEM * n, wb, [](int e) { return e; },
           [=](int e) {
             const int r = e / n, k = k0 + e % n, rl = r % halfM;
             return ((rl >> 2) * R2 + 2 * k + r / halfM) * 4 + (rl & 3);
           });
  }

  const size_t row0 = (size_t)b * T_;
  const int n_mr = L.RW - R;  // the MR row, then the R gamma hiddens of X
  auto fetch = [&](int s) {
    if (s < T_) {
      const size_t row = row0 + (T_ - 1 - s);
      const float* mr = a.MR + row * w.MW;
      const float* xg = a.X + row * w.XW + w.xo_g1;
      float* dst = ring + (s % kRing) * L.RW;
      for (int e = 2 * tid; e < L.RW; e += 2 * blockDim.x)
        cp_async<8>(dst + e, e < n_mr ? mr + e : xg + (e - n_mr), true);
    }
    cp_async_commit();
  };
  for (int s = 0; s < kRing - 1; ++s) fetch(s);

  const int r = tid >> 1, side = tid & 1;
  const bool in1 = tid < M2, in2 = tid < R2;
  const V* wa_v = reinterpret_cast<const V*>(wa) + tid;
  const V* wb_v = reinterpret_cast<const V*>(wb) + tid;
  const float4* dp_in = reinterpret_cast<const float4*>(dps + side * halfR);
  const int gk = r < hg1 ? 0 : 1;  // phase 2: row r is a gamma_gk hidden
  const float4* ds_in = reinterpret_cast<const float4*>(dss + gk * L.MEMp + side * halfM);
  const float keep = gk ? a.keep2 : a.keep1;
  float dmemp = 0.f;  // dm_{t+1} gamma1_{t+1}[r]
  cp_async_wait<kRing - 2>();
  __syncthreads();

  for (int s = 0; s < T_; ++s) {
    fetch(s + kRing - 1);
    const size_t row = row0 + (T_ - 1 - s);
    const float* x = ring + (s % kRing) * L.RW;
    float* G = a.G + row * w.GW;
    // phase 1: dmem, then mem_t = gamma1 mem_{t-1} + gamma2 c^ backwards
    float acc = in1 ? dot4(wa_v, M2, dp_in, halfR / 4) : 0.f;
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (in1) {
      const float dm = x[kGm * MEM + r] + (dmemp + acc);
      const float g1 = x[kGam1 * MEM + r], g2 = x[kGam2 * MEM + r], ch = x[kChat * MEM + r];
      if (side == 0) {
        const float ds1 = dm * x[kMemPrev * MEM + r] * g1 * (1.f - g1);
        dss[r] = ds1;
        G[w.go_ds1 + r] = ds1;
        G[w.go_dchat + r] = dm * g2 * (1.f - ch * ch);
      } else {
        const float ds2 = dm * ch * g2 * (1.f - g2);
        dss[L.MEMp + r] = ds2;
        G[w.go_ds2 + r] = ds2;
      }
      dmemp = dm * g1;
    }
    __syncthreads();
    // phase 2: the gamma hiddens' gradients through fc2, dropout and ReLU
    acc = in2 ? dot4(wb_v, R2, ds_in, halfM / 4) : 0.f;
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (in2 && side == 0) {
      const float dp = x[n_mr + r] > 0.f ? acc / keep : 0.f;
      dps[r] = dp;
      G[w.go_dp1 + r] = dp;
    }
    cp_async_wait<kRing - 2>();
    __syncthreads();
  }
}

// ---------------------------------------------------------------- S2

// out = mask > 0 ? acc : 0 (a ReLU's backward; mask is the ReLU's output),
// out = acc without a mask, or out += acc.
struct Grad {
  float* out;
  int ldo;
  const float* mask;
  int ldm;
  bool add;
  __device__ __forceinline__ void operator()(int m, int n, float acc) const {
    float& o = out[(size_t)m * ldo + n];
    if (add)
      o += acc;
    else
      o = (mask == nullptr || mask[(size_t)m * ldm + n] > 0.f) ? acc : 0.f;
  }
};

// One warp per row: the feature softmax's backward from d attended (held in
// G's dlog columns): datt = da c*, dlog = att (datt - sum(datt att)) in
// place, and d c* = da att into the LSTM scan's record.
__global__ void attend_bwd_kernel(float* __restrict__ G, const float* __restrict__ X,
                                  const float* __restrict__ att, float* __restrict__ L, int M,
                                  Widths w) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (row >= M) return;
  float* da = G + (size_t)row * w.GW + w.go_dlog;
  const float* cstar = X + (size_t)row * w.XW + w.xo_cstar;
  const float* at = att + (size_t)row * w.TH2;
  float* dcs = L + (size_t)row * w.LW + kDcPrev * w.TH;
  float part = 0.f;
  for (int i = lane; i < w.TH2; i += 32) part += (da[i] * cstar[i]) * at[i];
  part = warp_sum(part);
  for (int i = lane; i < w.TH2; i += 32) {
    const float d = da[i];
    dcs[i] = d * at[i];
    da[i] = at[i] * (d * cstar[i] - part);
  }
}

// ---------------------------------------------------------------- S3

struct LstmBwdArgs {
  const void* whh[kMaxMods];
  void* dxp[kMaxMods];
  int hid[kMaxMods];
  const float* L;
  float* G;
  int T;
  Widths w;
};

// Layout of an S3 block of modality width H in a block of `threads`: S
// lanes per hidden unit, each over G4p / S of the 4H gate rows of its column
// of W_hh (G4p: 4H padded to 4S).
struct LstmBwdLayout {
  int S, G4p, slice, nq, NT;  // lanes per unit, padded rows, rows per lane, chunks of 4, working threads
  __host__ __device__ LstmBwdLayout(int H, int threads) {
    S = lanes_per_unit(H, threads);
    G4p = round_up(4 * H, 4 * S);
    slice = G4p / S;
    nq = slice / 4;
    NT = H * S;
  }
  // W_hh^T as [nq][NT lanes][4] in the storage dtype (zero past 4H), then dz
  // double-buffered [2][G4p] and the ring of record rows [kRing][kLSlots H]
  __host__ __device__ size_t w_bytes(int H, size_t esize) const {
    return (size_t)G4p * H * esize;
  }
  __host__ __device__ size_t bytes(int H, size_t esize) const {
    return w_bytes(H, esize) + 2 * (size_t)G4p * sizeof(float) +
           (size_t)kRing * kLSlots * H * sizeof(float);
  }
};

// Block (b, m): video b, modality m, t from T-1 down.  Lane j S + part of
// hidden unit j sums its slice of W_hh[:, j] . dz; the S lanes are joined by
// shuffles and lane j S runs the cell's backward with (dh, dc) of unit j in
// registers, writing dz to d_xp (storage dtype), to G and to shared memory.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads) lstm_bwd_kernel(LstmBwdArgs a) {
  using V = typename Vec4<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Widths& w = a.w;
  const int b = blockIdx.x, m = blockIdx.y;
  const int H = a.hid[m], G4 = 4 * H, TH = w.TH, T_ = a.T;
  const LstmBwdLayout Ly(H, blockDim.x);
  const int S = Ly.S, NT = Ly.NT, slice = Ly.slice;
  int off = 0;
  for (int i = 0; i < m; ++i) off += a.hid[i];
  const size_t w_bytes = Ly.w_bytes(H, sizeof(T));
  float* dzs = reinterpret_cast<float*>(smem_raw + w_bytes);
  float* ring = dzs + 2 * Ly.G4p;
  zero_smem(smem_raw, w_bytes + 2 * (size_t)Ly.G4p * sizeof(float));
  __syncthreads();
  // W_hh [4H, H] row g, column j -> lane j S + g / slice, chunk (g % slice) / 4
  gather(static_cast<const T*>(a.whh[m]), G4 * H, reinterpret_cast<T*>(smem_raw),
         [](int e) { return e; },
         [=](int e) {
           const int g = e / H, j = e % H, gl = g % slice;
           return ((gl >> 2) * NT + j * S + g / slice) * 4 + (gl & 3);
         });

  const int tid = threadIdx.x, j = tid / S, part = tid % S;
  const bool active = tid < NT, owner = active && part == 0;
  const int RW = kLSlots * H;
  const size_t row0 = (size_t)b * T_;
  auto fetch = [&](int s) {
    if (s < T_) {
      const float* src = a.L + (row0 + T_ - 1 - s) * w.LW + off;
      float* dst = ring + (s % kRing) * RW;
      for (int e = 2 * tid; e < RW; e += 2 * blockDim.x) {
        const int q = e / H;  // H is even: a pair never straddles two slots
        cp_async<8>(dst + e, src + (size_t)q * TH + (e - q * H), true);
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < kRing - 1; ++s) fetch(s);
  T* dxp = static_cast<T*>(a.dxp[m]) + row0 * G4;
  float* Gz = a.G + row0 * w.GW + w.go_dz + 4 * off;
  const V* wv = reinterpret_cast<const V*>(smem_raw) + tid;
  float dh_c = 0.f, dc_c = 0.f;  // unit j's carries (lane j S)
  cp_async_wait<kRing - 2>();
  __syncthreads();

  for (int s = 0; s < T_; ++s) {
    fetch(s + kRing - 1);
    const int t = T_ - 1 - s;
    float* dz_buf = dzs + (s & 1) * Ly.G4p;
    if (owner) {
      // c_t = f c_{t-1} + i g, h_t = o tanh(c_t)
      const float* x = ring + (s % kRing) * RW + j;
      const float ig = x[kIg * H], fg = x[kFg * H], gg = x[kGg * H], og = x[kOg * H];
      const float tc = x[kTc * H];
      const float dh = x[kGh * H] + dh_c;
      float dcf = dc_c + x[kDcNew * H];
      const float d_o = dh * tc;
      dcf += dh * og * (1.f - tc * tc);
      const float di = dcf * gg, df = dcf * x[kCprev * H], dg = dcf * ig;
      dc_c = dcf * fg + x[kDcPrev * H];
      const float dz[4] = {di * ig * (1.f - ig), df * fg * (1.f - fg), dg * (1.f - gg * gg),
                           d_o * og * (1.f - og)};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dz_buf[q * H + j] = dz[q];
        dxp[(size_t)t * G4 + q * H + j] = from_f<T>(dz[q]);
        Gz[(size_t)t * w.GW + q * H + j] = dz[q];
      }
    }
    cp_async_wait<kRing - 2>();
    __syncthreads();
    if (s + 1 < T_) {
      // dh_{t-1} = W_hh^T dz
      float s0 = 0.f, s1 = 0.f;
      if (active) {
        const float4* d4 = reinterpret_cast<const float4*>(dz_buf + part * slice);
#pragma unroll 2
        for (int q = 0; q < Ly.nq; ++q) fma4(s0, s1, to_f4(wv[q * NT]), d4[q]);
      }
      float v[1] = {s0 + s1};
      lane_sums(v, S);
      dh_c = v[0];
    }
  }
}

// ---------------------------------------------------------------- S4

constexpr int kMaxWgJobs = kMaxMods + 8;
constexpr int WBN = 64, WBK = 64, WBM = 16, kWgThreads = 256;

// One parameter's gradient: dw[n, k] = sum over rows m of g[m, n] x[m, k]
// (torch layout [out, in]) and, with db, the bias db[n] = sum_m g[m, n],
// read as column K (= ones) of x.  Its split partials start at splits * out0.
struct WgJob {
  const float* g;
  const float* x;
  float* dw;
  float* db;
  int N, K, Kc, tiles_k, tile0;  // Kc = K + (db != null)
  long long out0;
};

struct WgJobs {
  WgJob job[kMaxWgJobs];
  int n_jobs, ldg, ldx, M, chunk, splits;
};

__device__ __forceinline__ int find_job(const WgJobs& js, long long i, bool by_tile) {
  int j = 0;
  while (j + 1 < js.n_jobs && i >= (by_tile ? js.job[j + 1].tile0 : js.job[j + 1].out0)) ++j;
  return j;
}

// Block (tile, z): one 64x64 output tile of one job over chunk z of the
// rows, written to part[splits * out0 + z * N * Kc + n * Kc + k].  16-row
// steps double-buffered through shared memory (the next step's loads in
// registers while this one computes), 4x4 neighbouring outputs per thread
// read as float4, as ff_gemm_kernel.  Each output sums each step's rows in
// order and adds the step's sum to its running sum (blocked summation:
// the error of a chunk's sum grows with 16 + rows / 16, not with its rows).
__global__ void __launch_bounds__(kWgThreads) wgrad_kernel(WgJobs js, float* __restrict__ part) {
  __shared__ __align__(16) float Gs[2][WBM][WBN + 4];
  __shared__ __align__(16) float Xs[2][WBM][WBK + 4];
  const WgJob jb = js.job[find_job(js, blockIdx.x, true)];
  const int tile = blockIdx.x - jb.tile0;
  const int n0 = (tile / jb.tiles_k) * WBN, k0 = (tile % jb.tiles_k) * WBK;
  const int z = blockIdx.y, m_begin = z * js.chunk, m_end = min(js.M, m_begin + js.chunk);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lr = tid >> 4, lc = (tid & 15) * 4;  // loader: row, first of 4 columns
  float rg[4], rx[4];
  auto load = [&](int m0) {
    const int m = m0 + lr;
    const bool ok = m < m_end;
    const float* grow = jb.g + (size_t)m * js.ldg;
    const float* xrow = jb.x + (size_t)m * js.ldx;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + lc + i, k = k0 + lc + i;
      rg[i] = ok && n < jb.N ? grow[n] : 0.f;
      rx[i] = !ok ? 0.f : k < jb.K ? xrow[k] : k < jb.Kc ? 1.f : 0.f;
    }
  };
  auto store = [&](int buf) {
    *reinterpret_cast<float4*>(&Gs[buf][lr][lc]) = make_float4(rg[0], rg[1], rg[2], rg[3]);
    *reinterpret_cast<float4*>(&Xs[buf][lr][lc]) = make_float4(rx[0], rx[1], rx[2], rx[3]);
  };
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  load(m_begin);
  store(0);
  __syncthreads();
  int buf = 0;
  for (int m0 = m_begin; m0 < m_end; m0 += WBM) {
    const bool more = m0 + WBM < m_end;
    if (more) load(m0 + WBM);
    float step[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) step[i][j] = 0.f;
#pragma unroll
    for (int mm = 0; mm < WBM; ++mm) {
      const float4 gv = *reinterpret_cast<const float4*>(&Gs[buf][mm][ty * 4]);
      const float4 xv = *reinterpret_cast<const float4*>(&Xs[buf][mm][tx * 4]);
      const float g4[4] = {gv.x, gv.y, gv.z, gv.w}, x4[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) step[i][j] = fmaf(g4[i], x4[j], step[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += step[i][j];
    if (more) store(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }
  const long long plane = (long long)jb.N * jb.Kc;
  float* out = part + js.splits * jb.out0 + z * plane;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty * 4 + i;
    if (n >= jb.N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tx * 4 + j;
      if (k < jb.Kc) out[(long long)n * jb.Kc + k] = acc[i][j];
    }
  }
}

// Thread per output of every job: the chunks' partials added in chunk order
// (compensated), into dw or, for column K, db.
__global__ void wgrad_sum_kernel(WgJobs js, const float* __restrict__ part, long long outs) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= outs) return;
  const WgJob jb = js.job[find_job(js, i, false)];
  const long long r = i - jb.out0, plane = (long long)jb.N * jb.Kc;
  const float* p = part + js.splits * jb.out0 + r;
  KahanSum s;
  for (int z = 0; z < js.splits; ++z) s.add(p[z * plane]);
  const int n = (int)(r / jb.Kc), k = (int)(r % jb.Kc);
  if (k < jb.K)
    jb.dw[(long long)n * jb.K + k] = s.s;
  else
    jb.db[n] = s.s;
}

// S4's products over M rows: W_hh of each modality, then the eight gate
// layers (att1 fc1/fc2, att2 fc1/fc2, gamma1 fc1/fc2, gamma2 fc1/fc2) with
// their biases; *tiles and *outs receive the output tiles and outputs.  G,
// X and the outputs may be null, to size the partials.
inline WgJobs wgrad_jobs(const Args& f, const Widths& w, int M, const float* G,
                         const float* X, void* const* dwhh, void* const* dgates, int* tiles,
                         long long* outs) {
  WgJobs js{};
  js.ldg = w.GW;
  js.ldx = w.XW;
  js.M = M;
  js.splits = grad_splits(M);
  js.chunk = round_up((M + js.splits - 1) / js.splits, WBM);
  js.splits = (M + js.chunk - 1) / js.chunk;
  *tiles = 0;
  *outs = 0;
  auto add = [&](int go, int N, int xo, int K, bool bias, void* dw, void* db) {
    WgJob& j = js.job[js.n_jobs++];
    const int Kc = K + bias;
    j = WgJob{G ? G + go : nullptr, X ? X + xo : nullptr, static_cast<float*>(dw),
              static_cast<float*>(db), N, K, Kc, (Kc + WBK - 1) / WBK, *tiles, *outs};
    *tiles += (N + WBN - 1) / WBN * j.tiles_k;
    *outs += (long long)N * Kc;
  };
  for (int m = 0, o = 0; m < f.n_mods; o += f.hid[m++])
    add(w.go_dz + 4 * o, 4 * f.hid[m], w.xo_hprev + o, f.hid[m], false,
        dwhh ? dwhh[m] : nullptr, nullptr);
  const int TH2 = w.TH2, MEM = w.MEM;
  const int lins[8][4] = {{w.go_dapre, w.h1, w.xo_cstar, TH2}, {w.go_dlog, TH2, w.xo_ah, w.h1},
                          {w.go_dbpre, w.h2, w.xo_both, TH2},  {w.go_dchat, MEM, w.xo_bh, w.h2},
                          {w.go_dp1, w.hg1, w.xo_both, w.gin}, {w.go_ds1, MEM, w.xo_g1, w.hg1},
                          {w.go_dp2, w.hg2, w.xo_both, w.gin}, {w.go_ds2, MEM, w.xo_g2, w.hg2}};
  for (int j = 0; j < 8; ++j)
    add(lins[j][0], lins[j][1], lins[j][2], lins[j][3], true,
        dgates ? dgates[2 * j] : nullptr, dgates ? dgates[2 * j + 1] : nullptr);
  return js;
}

// ---------------------------------------------------------------- host

// out[c * ldo + col0 + r] = in[r * ldi + c] for r < R, c < C: the first C
// columns of an [R, ldi] matrix, transposed into columns col0.. of out.
template <typename T>
__global__ void transpose_kernel(const T* __restrict__ in, int R, int C, int ldi,
                                 T* __restrict__ out, int ldo, int col0) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= (long long)R * C) return;
  const int r = (int)(i / C), c = (int)(i % C);
  out[(long long)c * ldo + col0 + r] = in[(long long)r * ldi + c];
}

template <typename T>
void transpose(const void* in, int R, int C, int ldi, T* out, int ldo, int col0,
               cudaStream_t st) {
  const long long n = (long long)R * C;
  transpose_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(static_cast<const T*>(in),
                                                                   R, C, ldi, out, ldo, col0);
}

// The backward's scratch, carved from one workspace allocation: S2's
// weights transposed ([N, K] rows of its products), the layer inputs X, the
// pre-activation gradients G, the scans' records L and MR, the attention
// weights, and the weight gradients' split-K partials.
template <typename T>
struct Work {
  T *a2w2T, *datT, *a1w2T, *a1w1T;
  float *X, *G, *L, *MR, *att, *part;
  static Work carve(Carver& c, const Args& f, const Widths& w) {
    Work k;
    k.a2w2T = c.take<T>((size_t)w.h2 * w.MEM);
    k.datT = c.take<T>((size_t)w.TH2 * (w.h2 + w.R));
    k.a1w2T = c.take<T>((size_t)w.h1 * w.TH2);
    k.a1w1T = c.take<T>((size_t)w.TH2 * w.h1);
    const size_t M = (size_t)f.B * f.T;
    k.X = c.take<float>(M * w.XW);
    k.G = c.take<float>(M * w.GW);
    k.L = c.take<float>(M * w.LW);
    k.MR = c.take<float>(M * w.MW);
    k.att = c.take<float>(M * w.TH2);
    int tiles = 0;
    long long outs = 0;
    const WgJobs js = wgrad_jobs(f, w, (int)M, nullptr, nullptr, nullptr, nullptr, &tiles, &outs);
    k.part = c.take<float>((size_t)js.splits * outs);
    return k;
  }
};

// The S3 block: threads for the modality that wants most, and the largest
// shared memory of any modality's layout at that count.
inline size_t lstm_bwd_block(const Args& f, size_t esize, int* threads) {
  int th = 0;
  for (int m = 0; m < f.n_mods; ++m) {
    const int H = f.hid[m];
    const int n = round_up(H * lanes_per_unit(H, kMaxThreads), 32);
    th = n > th ? n : th;
  }
  size_t s = 0;
  for (int m = 0; m < f.n_mods; ++m) {
    const size_t sm = LstmBwdLayout(f.hid[m], th).bytes(f.hid[m], esize);
    s = sm > s ? sm : s;
  }
  *threads = th;
  return s;
}

inline bool widths_ok(const Args& f) {
  const int ws[6] = {f.mem, f.h_att1, f.h_att2, f.h_g1, f.h_g2, f.total_h};
  for (int v : ws)
    if (v < 2 || v % 2) return false;
  for (int m = 0; m < f.n_mods; ++m)
    if (f.hid[m] < 2 || f.hid[m] % 2) return false;
  return true;
}

// Whether kernel 7's stages take these widths: each scan's block within
// 1,024 threads and the shared-memory opt-in, and the GEMMs' grids within
// 65,535 row tiles.
inline bool bwd_fits(const Args& f, size_t esize) {
  int th = 0;
  const size_t sm = lstm_bwd_block(f, esize, &th);
  const MemBwdLayout L(f.mem, f.h_g1, f.h_g2, esize);
  const long long M = (long long)f.B * f.T;
  return widths_ok(f) && th <= kMaxThreads && sm <= kSmemMax &&
         mem_bwd_threads(f.mem, f.h_g1 + f.h_g2) <= kMaxThreads && L.total <= kSmemMax &&
         (M + mfn_staged::FBM - 1) / mfn_staged::FBM <= 65535;
}

template <typename T>
int train_bwd(const BwdArgs& a, void* const* dwhh, void* const* dgates, void* ws,
              cudaStream_t st) {
  const Args& f = a.f;
  const Widths& w = a.w;
  const size_t es = sizeof(T);
  Carver c{static_cast<char*>(ws)};
  const Work<T> k = Work<T>::carve(c, f, w);
  const int M = f.B * f.T, TH = w.TH, TH2 = w.TH2, MEM = w.MEM, KD = w.h2 + w.R;
  auto W = [&](int i) { return static_cast<const T*>(f.g[i]); };
  using mfn::kNone;
  using mfn::kRelu;
  using mfn::kSigmoid;
  using mfn::kTanh;

  // S2's weights as the [N, K] rows of its products
  transpose<T>(W(6), MEM, w.h2, w.h2, k.a2w2T, MEM, 0, st);
  transpose<T>(W(4), w.h2, TH2, TH2, k.datT, KD, 0, st);
  transpose<T>(W(8), w.hg1, TH2, w.gin, k.datT, KD, w.h2, st);
  transpose<T>(W(12), w.hg2, TH2, w.gin, k.datT, KD, w.h2 + w.hg1, st);
  transpose<T>(W(2), TH2, w.h1, w.h1, k.a1w2T, TH2, 0, st);
  transpose<T>(W(0), w.h1, TH2, TH2, k.a1w1T, w.h1, 0, st);

  // S0: every step recomputed at once
  prep_kernel<T><<<M, 256, 0, st>>>(
      PrepArgs{a.hs, a.cs, a.mems, a.g_hs, a.g_mems, k.X, k.L, k.MR, f.T, w});
  for (int m = 0, off = 0; m < f.n_mods; off += f.hid[m++]) {
    const int H = f.hid[m];
    const FfJob<T, AddXp<T>> z{static_cast<const T*>(f.whh[m]), H, 4 * H,
                               {k.G + w.go_dz + 4 * off, w.GW,
                                static_cast<const T*>(f.xp[m]), 4 * H}};
    ff_gemm<T>(k.X + w.xo_hprev + off, w.XW, M, H, &z, 1, st);
  }
  CellArgs ca{{}, k.G, k.X, k.L, M, w};
  for (int m = 0; m < kMaxMods; ++m) ca.hid[m] = f.hid[m];
  cell_kernel<<<(unsigned)(((long long)M * TH + 255) / 256), 256, 0, st>>>(ca);
  const FfJob<T, Bias<T>> att1_fc1{W(0), TH2, w.h1, {k.X + w.xo_ah, w.XW, W(1), kRelu}};
  ff_gemm<T>(k.X + w.xo_cstar, w.XW, M, TH2, &att1_fc1, 1, st);
  const FfJob<T, Bias<T>> att1_fc2{W(2), w.h1, TH2, {k.att, TH2, W(3), kNone}};
  ff_gemm<T>(k.X + w.xo_ah, w.XW, M, w.h1, &att1_fc2, 1, st);
  attend_kernel<<<(M + 7) / 8, 256, 0, st>>>(k.att, k.X, M, w);
  const FfJob<T, Bias<T>> att2_fc1{W(4), TH2, w.h2, {k.X + w.xo_bh, w.XW, W(5), kRelu}};
  ff_gemm<T>(k.X + w.xo_both, w.XW, M, TH2, &att2_fc1, 1, st);
  const FfJob<T, GammaDrop<T>> gamma_fc1[2] = {
      {W(8), w.gin, w.hg1,
       {k.X + w.xo_g1, w.XW, W(9), f.seeds, 0, f.T, w.hg1, f.thr1, f.keep1}},
      {W(12), w.gin, w.hg2,
       {k.X + w.xo_g2, w.XW, W(13), f.seeds, 1, f.T, w.hg2, f.thr2, f.keep2}}};
  ff_gemm<T>(k.X + w.xo_both, w.XW, M, w.gin, gamma_fc1, 2, st);
  const FfJob<T, Bias<T>> att2_fc2{W(6), w.h2, MEM, {k.MR + kChat * MEM, w.MW, W(7), kTanh}};
  ff_gemm<T>(k.X + w.xo_bh, w.XW, M, w.h2, &att2_fc2, 1, st);
  const FfJob<T, Bias<T>> g1_fc2{W(10), w.hg1, MEM, {k.MR + kGam1 * MEM, w.MW, W(11), kSigmoid}};
  ff_gemm<T>(k.X + w.xo_g1, w.XW, M, w.hg1, &g1_fc2, 1, st);
  const FfJob<T, Bias<T>> g2_fc2{W(14), w.hg2, MEM, {k.MR + kGam2 * MEM, w.MW, W(15), kSigmoid}};
  ff_gemm<T>(k.X + w.xo_g2, w.XW, M, w.hg2, &g2_fc2, 1, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // S1: the memory reverse scan
  const MemBwdLayout L1(MEM, w.hg1, w.hg2, es);
  err = cudaFuncSetAttribute(mem_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L1.total);
  if (err != cudaSuccess) return (int)err;
  mem_bwd_kernel<T><<<f.B, mem_bwd_threads(MEM, w.R), L1.total, st>>>(
      MemBwdArgs{{f.g[8], f.g[12]}, {f.g[10], f.g[14]}, k.MR, k.X, k.G, f.keep1, f.keep2, f.T,
                 w});
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // S2: the rest of the VJP, every row at once
  const FfJob<T, Grad> dbh{k.a2w2T, MEM, w.h2,
                           {k.G + w.go_dbpre, w.GW, k.X + w.xo_bh, w.XW, false}};
  ff_gemm<T>(k.G + w.go_dchat, w.GW, M, MEM, &dbh, 1, st);
  const FfJob<T, Grad> dattended{k.datT, KD, TH2, {k.G + w.go_dlog, w.GW, nullptr, 0, false}};
  ff_gemm<T>(k.G + w.go_dbpre, w.GW, M, KD, &dattended, 1, st);
  attend_bwd_kernel<<<(M + 7) / 8, 256, 0, st>>>(k.G, k.X, k.att, k.L, M, w);
  const FfJob<T, Grad> dah{k.a1w2T, TH2, w.h1, {k.G + w.go_dapre, w.GW, k.X + w.xo_ah, w.XW,
                                                false}};
  ff_gemm<T>(k.G + w.go_dlog, w.GW, M, TH2, &dah, 1, st);
  const FfJob<T, Grad> dcstar{k.a1w1T, w.h1, TH2,
                              {k.L + kDcPrev * TH, w.LW, nullptr, 0, true}};
  ff_gemm<T>(k.G + w.go_dapre, w.GW, M, w.h1, &dcstar, 1, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // S3: the LSTM reverse scan
  LstmBwdArgs la{};
  for (int m = 0; m < f.n_mods; ++m) {
    la.whh[m] = f.whh[m];
    la.dxp[m] = a.dxp[m];
    la.hid[m] = f.hid[m];
  }
  la.L = k.L;
  la.G = k.G;
  la.T = f.T;
  la.w = w;
  int th3 = 0;
  const size_t sm3 = lstm_bwd_block(f, es, &th3);
  err = cudaFuncSetAttribute(lstm_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sm3);
  if (err != cudaSuccess) return (int)err;
  lstm_bwd_kernel<T><<<dim3(f.B, f.n_mods), th3, sm3, st>>>(la);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // S4: parameter gradients over all B*T rows, torch layout [out, in]
  int tiles = 0;
  long long outs = 0;
  const WgJobs js = wgrad_jobs(f, w, M, k.G, k.X, dwhh, dgates, &tiles, &outs);
  wgrad_kernel<<<dim3(tiles, js.splits), kWgThreads, 0, st>>>(js, k.part);
  wgrad_sum_kernel<<<(unsigned)((outs + 255) / 256), 256, 0, st>>>(js, k.part, outs);
  return (int)cudaGetLastError();
}

// The shapes of kernel 7's C arguments, or false for shapes it cannot take.
inline bool parse(Args& a, int dtype, const void* xp, const void* whh, const void* hid,
                  int n_mods, const void* gates, int B, int T, int mem, int h_att1, int h_att2,
                  int h_g1, int h_g2) {
  if (dtype != kF32 && dtype != kBF16) return false;
  if (!mfn::fill_args(a, xp, whh, hid, n_mods, gates, B, T, mem, h_att1, h_att2, h_g1, h_g2))
    return false;
  return bwd_fits(a, dtype == kF32 ? sizeof(float) : sizeof(__nv_bfloat16));
}

}  // namespace mfnt
}  // namespace mmtx

// Kernel 6.  As mmtx_mfn_scan, plus cs (every c_t, storage dtype), the
// per-step seeds [T, 2] uint32 on the device, and the gamma1/gamma2 drop
// thresholds and keep probabilities; ws: mmtx_mfn_scan_workspace bytes.
// Launches kernel B's three stages in their training instantiations on the
// stream; returns the first CUDA error, or cudaErrorInvalidValue for shapes
// the stages refuse.
extern "C" int mmtx_mfn_train_fwd(int dtype, const void* xp, const void* whh,
                                  const void* hid, int n_mods, const void* gates,
                                  const void* seeds, unsigned thr1, unsigned thr2,
                                  float keep1, float keep2, void* hs, void* cs,
                                  void* mems, void* ws, int B, int T, int mem, int h_att1,
                                  int h_att2, int h_g1, int h_g2, void* stream) {
  using namespace mmtx;
  mfn::Args a;
  if (!mfn_staged::parse(a, dtype, xp, whh, hid, n_mods, gates, B, T, mem, h_att1, h_att2,
                         h_g1, h_g2))
    return (int)cudaErrorInvalidValue;
  a.hs = hs;
  a.mems = mems;
  a.cs = cs;
  a.seeds = static_cast<const uint32_t*>(seeds);
  a.thr1 = thr1; a.thr2 = thr2; a.keep1 = keep1; a.keep2 = keep2;
  return mfn_staged::launch(a, dtype, ws, static_cast<cudaStream_t>(stream));
}

// Workspace bytes of kernel 7, or -1 for shapes it refuses.
extern "C" long long mmtx_mfn_train_workspace(int dtype, const void* hid, int n_mods, int B,
                                              int T, int mem, int h_att1, int h_att2,
                                              int h_g1, int h_g2) {
  using namespace mmtx;
  mfn::Args a;
  const void* none[mfn::kMaxMods] = {nullptr, nullptr, nullptr, nullptr};
  const void* g16[16] = {};
  if (!mfnt::parse(a, dtype, none, none, hid, n_mods, g16, B, T, mem, h_att1, h_att2, h_g1,
                   h_g2))
    return -1;
  const mfnt::Widths w = mfnt::Widths::make(a.total_h, mem, h_att1, h_att2, h_g1, h_g2);
  Carver c{nullptr};
  if (dtype == kBF16)
    mfnt::Work<__nv_bfloat16>::carve(c, a, w);
  else
    mfnt::Work<float>::carve(c, a, w);
  return (long long)c.used + 256;
}

// Kernel 7.  xp/whh/hid/gates as kernel 6; hs, cs, mems: kernel 6's saved
// states; g_hs [B, T, total_h] and g_mems [B, T, mem]: fp32 cotangents;
// dxp: host array of n_mods device pointers [B, T, 4H_m] (storage dtype);
// dwhh: n_mods fp32 [4H_m, H_m]; dgates: 16 fp32 buffers shaped like the
// gate tensors; workspace: mmtx_mfn_train_workspace bytes.  Launches the
// five stages on the stream; every output is written whole.  Returns the
// first CUDA error, or cudaErrorInvalidValue for shapes the stages refuse.
extern "C" int mmtx_mfn_train_bwd(int dtype, const void* xp, const void* whh,
                                  const void* hid, int n_mods, const void* gates,
                                  const void* seeds, unsigned thr1, unsigned thr2,
                                  float keep1, float keep2, const void* hs,
                                  const void* cs, const void* mems, const void* g_hs,
                                  const void* g_mems, const void* dxp, const void* dwhh,
                                  const void* dgates, void* workspace, int B, int T,
                                  int mem, int h_att1, int h_att2, int h_g1, int h_g2,
                                  void* stream) {
  using namespace mmtx;
  mfnt::BwdArgs a;
  if (!mfnt::parse(a.f, dtype, xp, whh, hid, n_mods, gates, B, T, mem, h_att1, h_att2, h_g1,
                   h_g2))
    return (int)cudaErrorInvalidValue;
  a.f.seeds = static_cast<const uint32_t*>(seeds);
  a.f.thr1 = thr1; a.f.thr2 = thr2; a.f.keep1 = keep1; a.f.keep2 = keep2;
  a.hs = hs;
  a.cs = cs;
  a.mems = mems;
  a.g_hs = static_cast<const float*>(g_hs);
  a.g_mems = static_cast<const float*>(g_mems);
  void* const* dx = static_cast<void* const*>(const_cast<void*>(dxp));
  for (int m = 0; m < mfn::kMaxMods; ++m) a.dxp[m] = m < n_mods ? dx[m] : nullptr;
  a.w = mfnt::Widths::make(a.f.total_h, mem, h_att1, h_att2, h_g1, h_g2);
  void* const* dw = static_cast<void* const*>(const_cast<void*>(dwhh));
  void* const* dg = static_cast<void* const*>(const_cast<void*>(dgates));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return mfnt::train_bwd<float>(a, dw, dg, workspace, st);
  return mfnt::train_bwd<__nv_bfloat16>(a, dw, dg, workspace, st);
}
