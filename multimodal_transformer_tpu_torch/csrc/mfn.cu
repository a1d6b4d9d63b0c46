// Kernels B and 6: the whole T-step Memory Fusion Network recurrence as
// three stages launched in order on one stream, eval mode (kernel B, C entry
// mmtx_mfn_scan) and training mode (kernel 6, C entry mmtx_mfn_train_fwd in
// csrc/mfn_train.cu, which calls launch() below).  Rows 8 and 9 launch the
// same stages on the TPU kernels' packed and padded weights
// (csrc/mfn_variants.cu): the stages read every weight through its row
// stride, W_hh also through its gate stride, and a c workspace row may hold
// pad lanes (mfn::Args); kernels B and 6 pass the natural layout.
//
// Replaces: multimodal_transformer_tpu/ops/pallas/mfn_kernel.py
//   mfn_scan_pallas (body _mfn_kernel), and
//   multimodal_transformer_tpu/ops/pallas/mfn_train.py _fwd_call (body
//   _fwd_kernel).
//
// Per step t, for each modality: LSTMCell hidden-to-hidden with gates i,f,g,o
// on top of the hoisted input projection xp[b, t] (x @ W_ih^T + b_ih + b_hh,
// computed outside); then c* = [c_{t-1}; c_t], att1 (Linear-ReLU-Linear, softmax
// over the FEATURE axis), attended = att * c*, c^ = tanh(att2(attended)),
// gamma1/gamma2 = sigmoid(MLP([attended; mem])), mem = g1 * mem + g2 * c^.
// In training (kernel 6) the two gamma hiddens take hash dropout after their
// ReLU (element (b, c) of the [B, width] hidden kept when fmix32(b * width +
// c, seeds[t, k]) >= threshold, a kept value divided by keep_p) and every c_t
// is stored beside h_t and mem_t.
// State, workspace and arithmetic are fp32; weights and xp are read in their
// storage dtype; the per-step hidden concat, c_t and memory are written in
// that dtype.
//
// Only two quantities carry state from step to step: the LSTM state (h, c),
// through W_hh, and the memory, which enters only through the mem columns
// [2TH:] of the gamma fc1 layers and through the update.  Everything else
// depends on c_{t-1} and c_t alone, so the recurrence splits into
//   1. the LSTM scan (lstm_scan_kernel): one block per (video, modality)
//      loops over t with W_hh in shared memory; a step is one barrier phase;
//   2. the feed-forward part over all B*(T+1) rows at once: att1, the
//      feature softmax and attended, att2 and c^, and the attended columns
//      [:2TH] of both gamma fc1 layers plus their biases (P1, P2), as FMA
//      GEMMs with fused epilogues (mfn_staged.cuh ff_gemm_kernel, shared
//      with kernel 7) and a row softmax
//      (attend_kernel);
//   3. the memory scan (mem_scan_kernel): one block per video loops over t
//      with the mem side of both gamma MLPs in shared memory; a step is two
//      barrier phases.  Kernel 6's dropout sits in its first phase; the keep
//      bits do not depend on the data, so step t + 1's are hashed during
//      step t from a seed loaded a step earlier, and no step waits on a
//      load for them.
// The only change in the order of operations against a step-by-step
// recurrence: gamma fc1's sum is split into its attended part (stage 2) and
// its mem part (stage 3).
//
// What bounds it on the H100: each scan's step is a short chain that no
// other work hides (one block per SM, T steps in series): the products'
// shared-memory reads (a warp's broadcast float4 read of h or mem costs as
// many cycles as a full one), the shuffles that join a row's lanes, the cell's
// or gates' exponentials and divisions, and the barrier; about 1.3 us a step
// for stage 1 and 1.5 for stage 3 at the MFT's widths; kernel 6's stage 3
// takes ~0.3 us a step more, mostly for the IEEE division of each kept
// hidden by keep_p on its chain.  Stage 2 holds ~75% of
// the multiply-adds; it runs on the fp32 FMA pipes (the activations are fp32,
// so the tensor cores would change the rounding) and is bound by its shared
// reads, four float4 reads per 16 FMAs a thread.
//
// What the design does about it: the chain per step holds only W_hh . h (one
// barrier) and the two short mem products (two barriers), with the weights in
// one SM's shared memory (opt-in past 48 KB) laid out so that each warp's
// reads of its rows' next four weights are conflict-free.  In stage 1 a thread
// sums a slice of all four gate rows of its hidden unit, so one read of h
// serves four rows and the cell update needs no phase of its own; h is
// double-buffered; the xp rows of the next steps arrive through cp.async into
// a ring in shared memory.  Stage 3 loads P and c^ of step t+1 while step t
// computes (and kernel 6's seed of step t+2).  Each stage's eval and
// training instantiations differ only in the store of c_t (stage 1) and the
// dropout (stage 3): kernel B's code is unchanged.  No atomics: the same
// inputs give the same bits.

#include "mfn_staged.cuh"

namespace mmtx {
namespace mfn_staged {

using mfn::Args;

// ---------------------------------------------------------------- stage 1

// Layout of one stage-1 block of modality width H in a block of `threads`:
// S lanes per hidden unit, each over Hp / S columns of its four gate rows
// (Hp: H padded to 4S).
struct LstmLayout {
  int S, Hp, nq, NT;  // lanes per unit, padded width, chunks of 4 per lane, working threads
  __host__ __device__ LstmLayout(int H, int threads) {
    S = lanes_per_unit(H, threads);
    Hp = round_up(H, 4 * S);
    nq = Hp / (4 * S);
    NT = H * S;
  }
  // W_hh as [nq][4 gates][NT lanes][4] (zero past H), then h double-buffered
  // [2][Hp] and the ring of xp rows [kRing][4H]
  __host__ __device__ size_t w_bytes(int H, size_t esize) const {
    return (size_t)Hp * 4 * H * esize;
  }
  __host__ __device__ size_t bytes(int H, size_t esize) const {
    return w_bytes(H, esize) + 2 * (size_t)Hp * sizeof(float) + (size_t)kRing * 4 * H * esize;
  }
};

// Threads a stage-1 block may have: 1,024, or 512 in fp32, where every
// width that would want more (H > 128) already passes the shared memory
// with W_hh alone; the lower bound leaves the fp32 sums 128 registers a
// thread instead of 64, so they stay out of local memory.
template <typename T>
constexpr int lstm_max_threads() {
  return sizeof(T) == sizeof(float) ? 512 : kMaxThreads;
}

// Block (b, m): video b, modality m.  Thread j S + part sums the part-th
// slice of the four gate rows (i, f, g, o) of hidden unit j; the S lanes of
// a unit are joined by shuffles and lane j S updates the cell.  Writes
// hs[b, t, off_m + j] in the storage dtype and c_t to lane c_off[m] + j of
// the fp32 c row (b, t + 1), with row (b, 0) = c_{-1} = 0, and 0 to the pad
// lanes that follow the modality's in every c row (none in the natural
// layout); kStoreC (kernel 6): also c_t to a.cs[b, t, off_m + j] in the
// storage dtype.  xp rows must be 16-byte aligned.
template <typename T, bool kStoreC>
__global__ void __launch_bounds__(lstm_max_threads<T>()) lstm_scan_kernel(Args a, float* cs) {
  using V = typename Vec4<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x, m = blockIdx.y;
  const int H = a.hid[m], G = 4 * H, TH = a.total_h, CW = a.c_width, T_ = a.T;
  const LstmLayout L(H, blockDim.x);
  const int S = L.S, Hp = L.Hp, NT = L.NT, slice = Hp / S;
  int off = 0;
  for (int i = 0; i < m; ++i) off += a.hid[i];
  const size_t w_bytes = L.w_bytes(H, sizeof(T));
  float* hbuf = reinterpret_cast<float*>(smem_raw + w_bytes);
  T* ring = reinterpret_cast<T*>(smem_raw + w_bytes + 2 * (size_t)Hp * sizeof(float));
  zero_smem(smem_raw, L.bytes(H, sizeof(T)));
  __syncthreads();
  // W_hh row g H + j (the view's row g whh_gate + j), column i -> gate g,
  // lane j S + i / slice, chunk (i % slice) / 4.  The natural layout's
  // copy takes no index arithmetic (it is ALU-bound).
  const int ld = a.whh_ld[m], gate_rows = a.whh_gate[m];
  const T* whh = static_cast<const T*>(a.whh[m]);
  auto to_smem = [=](int e) {
    const int r = e / H, i = e % H, il = i % slice;
    return (((il >> 2) * 4 + r / H) * NT + (r % H) * S + i / slice) * 4 + (il & 3);
  };
  if (ld == H && gate_rows == H)
    gather(whh, G * H, reinterpret_cast<T*>(smem_raw), [](int e) { return e; }, to_smem);
  else
    gather(whh, G * H, reinterpret_cast<T*>(smem_raw),
           [=](int e) {
             const int r = e / H;
             return ((r / H) * gate_rows + r % H) * ld + e % H;
           },
           to_smem);

  const int tid = threadIdx.x, j = tid / S, part = tid % S;
  const bool active = tid < NT, owner = active && part == 0;
  constexpr int kPer = 16 / sizeof(T);  // elements per 16-byte copy
  const int chunks = G / kPer;          // G * sizeof(T) is a multiple of 16 (H even)
  const T* xp = static_cast<const T*>(a.xp[m]) + (size_t)b * T_ * G;
  auto fetch = [&](int t) {
    if (t < T_)
      for (int i = tid; i < chunks; i += blockDim.x)
        cp_async<16>(ring + (t % kRing) * G + i * kPer, xp + (size_t)t * G + i * kPer, true);
    cp_async_commit();
  };
  for (int t = 0; t < kRing - 1; ++t) fetch(t);
  T* hs = static_cast<T*>(a.hs) + (size_t)b * T_ * TH + off;
  float* csb = cs + (size_t)b * (T_ + 1) * CW + a.c_off[m];
  const int pad0 = a.c_off[m] + H, pad = (m + 1 < a.n_mods ? a.c_off[m + 1] : CW) - pad0;
  for (int i = tid; i < (T_ + 1) * pad; i += blockDim.x)
    cs[((size_t)b * (T_ + 1) + i / pad) * CW + pad0 + i % pad] = 0.f;
  T* cs_out = kStoreC ? static_cast<T*>(a.cs) + (size_t)b * T_ * TH + off : nullptr;
  if (owner) csb[j] = 0.f;
  const V* w = reinterpret_cast<const V*>(smem_raw) + tid;
  float c = 0.f;
  cp_async_wait<kRing - 2>();
  __syncthreads();

  for (int t = 0; t < T_; ++t) {
    fetch(t + kRing - 1);
    float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
    if (active) {
      const float4* h4 = reinterpret_cast<const float4*>(hbuf + (t & 1) * Hp + part * slice);
#pragma unroll 2
      for (int q = 0; q < L.nq; ++q) {
        const float4 hv = h4[q];
#pragma unroll
        for (int g = 0; g < 4; ++g) fma4(s0[g], s1[g], to_f4(w[(q * 4 + g) * NT]), hv);
      }
    }
    float z[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) z[g] = s0[g] + s1[g];
    lane_sums(z, S);
    if (owner) {
      const T* x = ring + (t % kRing) * G + j;
      const float zi = z[0] + to_f(x[0]), zf = z[1] + to_f(x[H]);
      const float zg = z[2] + to_f(x[2 * H]), zo = z[3] + to_f(x[3 * H]);
      c = sigmoidf(zf) * c + sigmoidf(zi) * tanhf(zg);
      const float h = sigmoidf(zo) * tanhf(c);
      hbuf[((t + 1) & 1) * Hp + j] = h;
      hs[(size_t)t * TH + j] = from_f<T>(h);
      csb[(size_t)(t + 1) * CW + j] = c;
      if (kStoreC) cs_out[(size_t)t * TH + j] = from_f<T>(c);
    }
    cp_async_wait<kRing - 2>();
    __syncthreads();
  }
}

// ---------------------------------------------------------------- stage 2

// One warp per row: x <- softmax(x) * c*, over the n = 2 CW features; row
// m's c* is the 2 CW floats at cs + m * CW (c_{t-1} then c_t, CW the c
// row's width).
__global__ void attend_kernel(float* __restrict__ logits, const float* __restrict__ cs, int M,
                              int CW) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (row >= M) return;
  const int n = 2 * CW;
  float* x = logits + (size_t)row * n;
  const float* cstar = cs + (size_t)row * CW;
  float mx = -INFINITY;
  for (int i = lane; i < n; i += 32) mx = fmaxf(mx, x[i]);
  mx = warp_max(mx);
  float sum = 0.f;
  for (int i = lane; i < n; i += 32) sum += expf(x[i] - mx);
  sum = warp_sum(sum);
  for (int i = lane; i < n; i += 32) x[i] = expf(x[i] - mx) / sum * cstar[i];
}

// ---------------------------------------------------------------- stage 3

struct MemArgs {
  const void* w1[2];  // gamma_k fc1's mem columns [hg_k, MEM], rows ld1[k] apart
  const void* w2[2];  // gamma_k fc2 weight [MEM, hg_k], rows ld2[k] apart
  const void* b2[2];  // gamma_k fc2 bias [MEM]
  const float* P;     // [rows, hg1 + hg2]: gamma1 fc1, then gamma2 fc1, on attended + bias
  const float* chat;  // [rows, MEM]
  void* mems;         // [B, T, MEM]
  int T, mem, hg1, hg2, ld1[2], ld2[2];
  // kernel 6's gamma-hidden dropout: the seeds [T, 2] (gamma1, gamma2 of
  // each step), and each hidden's threshold and keep probability
  const uint32_t* seeds;
  uint32_t thr[2];
  float keep[2];
};

// Shared memory of a stage-3 block, in bytes at the offsets: wa
// [MEMp/2/4][2 Ra][4] and wb [HGp/4][2 MEM][4] in the storage dtype (zero
// past each layer's columns), then fp32 mem [MEMp], the gamma hiddens
// [2][HGp] and the fc2 biases [2 MEM].
struct MemLayout {
  int MEMp, half, Ra, HGp;
  size_t wa, wb, memv, gh, bias, total;
  __host__ __device__ MemLayout(int mem, int hg1, int hg2, size_t esize) {
    MEMp = round_up(mem, 8);
    half = MEMp / 2;
    Ra = hg1 + hg2;
    HGp = round_up(hg1 > hg2 ? hg1 : hg2, 4);
    wa = 0;
    wb = wa + (size_t)MEMp * Ra * esize;
    memv = wb + (size_t)HGp * 2 * mem * esize;
    gh = memv + (size_t)MEMp * sizeof(float);
    bias = gh + 2 * (size_t)HGp * sizeof(float);
    total = bias + (size_t)round_up(2 * mem, 4) * sizeof(float);
  }
};

inline int mem_threads(int mem, int hg1, int hg2) {
  const int n = hg1 + hg2 > mem ? hg1 + hg2 : mem;
  return round_up(2 * n, 32);
}

// Block b: video b.  Phase a, thread i = 2r + half (r < hg1 + hg2, the
// gamma1 hidden rows, then gamma2's): g_h[r] = relu(P[r] + W_mem[r, :] .
// mem), the two halves of the mem axis joined by a shuffle.  Phase b, thread
// i = 2r + k (r < MEM): g_k[r] = sigmoid(fc2_k[r, :] . g_kh + bias), joined
// by a shuffle; thread 2r then updates mem[r] = g1 mem + g2 c^.  P and c^ of
// step t + 1 are loaded while step t computes.  kDrop (kernel 6): in phase
// a, thread 2r drops hidden row r of gamma k (r < hg1: k = 1, position b hg1
// + r; else k = 2, position b hg2 + r - hg1) by its keep bit under seeds[t,
// k]; the bit of step t + 1 is hashed during step t, from the seed loaded
// during step t - 1.
template <typename T, bool kDrop>
__global__ void __launch_bounds__(kMaxThreads) mem_scan_kernel(MemArgs a) {
  using V = typename Vec4<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int MEM = a.mem, hg1 = a.hg1, hg2 = a.hg2;
  const MemLayout L(MEM, hg1, hg2, sizeof(T));
  const int Ra2 = 2 * L.Ra, M2 = 2 * MEM, half = L.half;
  float* memv = reinterpret_cast<float*>(smem_raw + L.memv);
  float* gh = reinterpret_cast<float*>(smem_raw + L.gh);
  float* bias = reinterpret_cast<float*>(smem_raw + L.bias);
  const int b = blockIdx.x, tid = threadIdx.x, T_ = a.T;
  zero_smem(smem_raw, L.total);
  __syncthreads();
  T* wa = reinterpret_cast<T*>(smem_raw + L.wa);
  T* wb = reinterpret_cast<T*>(smem_raw + L.wb);
  for (int g = 0; g < 2; ++g) {
    const int n = g ? hg2 : hg1, r0 = g ? hg1 : 0, ld1 = a.ld1[g], ld2 = a.ld2[g];
    // gamma_g fc1 row r, mem column c -> lane 2 (r0 + r) + c / half
    gather(static_cast<const T*>(a.w1[g]), n * MEM, wa,
           [=](int e) { return (e / MEM) * ld1 + e % MEM; },
           [=](int e) {
             const int r = e / MEM, c = e % MEM, cl = c % half;
             return ((cl >> 2) * Ra2 + 2 * (r0 + r) + c / half) * 4 + (cl & 3);
           });
    // gamma_g fc2 row r, column c -> lane 2 r + g (without index arithmetic
    // where its rows are contiguous)
    const T* w2 = static_cast<const T*>(a.w2[g]);
    auto to_wb = [=](int e) {
      const int r = e / n, c = e % n;
      return ((c >> 2) * M2 + 2 * r + g) * 4 + (c & 3);
    };
    if (ld2 == n)
      gather(w2, MEM * n, wb, [](int e) { return e; }, to_wb);
    else
      gather(w2, MEM * n, wb, [=](int e) { return (e / n) * ld2 + e % n; }, to_wb);
    for (int i = tid; i < MEM; i += blockDim.x)
      bias[2 * i + g] = to_f(static_cast<const T*>(a.b2[g])[i]);
  }

  const int r = tid >> 1, side = tid & 1;
  const bool in_a = tid < Ra2, in_b = tid < M2;
  const bool take_p = in_a && side == 0, take_c = in_b && side == 0;
  const size_t row0 = (size_t)b * (T_ + 1);
  const float* P = a.P + row0 * L.Ra + r;
  const float* chat = a.chat + row0 * MEM + r;
  T* mems = static_cast<T*>(a.mems) + (size_t)b * T_ * MEM + r;
  const V* wa_v = reinterpret_cast<const V*>(wa) + tid;
  const V* wb_v = reinterpret_cast<const V*>(wb) + tid;
  const float4* mem_in = reinterpret_cast<const float4*>(memv + side * half);
  const float4* gh_in = reinterpret_cast<const float4*>(gh + side * L.HGp);
  float* gh_out = gh + (r < hg1 ? r : L.HGp + r - hg1);
  float p_next = take_p ? P[0] : 0.f, c_next = take_c ? chat[0] : 0.f;
  float mem_r = 0.f;
  // kDrop: this row's gamma (gk = k - 1), position, threshold, keep
  // probability and seeds column; keep_next holds the keep bit of step t + 1
  // (of step 0 before the loop), seed_next the seed of step t + 2 (of step 1)
  const int gk = r < hg1 ? 0 : 1;
  const uint32_t pos = (uint32_t)(gk ? b * hg2 + r - hg1 : b * hg1 + r);
  const uint32_t* seed = nullptr;
  uint32_t thr = 0, seed_next = 0;
  float keep_p = 1.f;
  bool keep_next = true;
  if constexpr (kDrop) {
    if (take_p) {
      seed = a.seeds + gk;
      thr = a.thr[gk];
      keep_p = a.keep[gk];
      keep_next = fmix_hash(pos, seed[0]) >= thr;
      if (T_ > 1) seed_next = seed[2];
    }
  }
  __syncthreads();

  for (int t = 0; t < T_; ++t) {
    const float p_cur = p_next, c_cur = c_next;
    [[maybe_unused]] const bool keep_cur = keep_next;
    if (t + 1 < T_) {
      if (take_p) p_next = P[(size_t)(t + 1) * L.Ra];
      if (take_c) c_next = chat[(size_t)(t + 1) * MEM];
      if constexpr (kDrop) {
        if (take_p) {
          keep_next = fmix_hash(pos, seed_next) >= thr;
          if (t + 2 < T_) seed_next = seed[2 * (t + 2)];
        }
      }
    }
    // phase a: the gamma hiddens
    float s = in_a ? dot4(wa_v, Ra2, mem_in, half / 4) : 0.f;
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (take_p) {
      const float v = fmaxf(p_cur + s, 0.f);
      if constexpr (kDrop)
        *gh_out = keep_cur ? v / keep_p : 0.f;
      else
        *gh_out = v;
    }
    __syncthreads();
    // phase b: gamma1, gamma2 and the memory update
    float g = 0.f;
    if (in_b) g = sigmoidf(dot4(wb_v, M2, gh_in, L.HGp / 4) + bias[tid]);
    const float g2 = __shfl_xor_sync(0xffffffffu, g, 1);
    if (take_c) {
      mem_r = g * mem_r + g2 * c_cur;
      memv[r] = mem_r;
      mems[(size_t)t * MEM] = from_f<T>(mem_r);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- host

struct Work {
  float *cs, *hid, *att, *P, *chat;
  static Work carve(Carver& c, const Args& a) {
    const size_t rows = (size_t)a.B * (a.T + 1), M = rows - 1;
    const int hmax = a.h_att1 > a.h_att2 ? a.h_att1 : a.h_att2;
    Work w;
    w.cs = c.take<float>(rows * a.c_width);
    w.hid = c.take<float>(M * hmax);
    w.att = c.take<float>(M * 2 * a.c_width);
    w.P = c.take<float>(M * (a.h_g1 + a.h_g2));
    w.chat = c.take<float>(M * a.mem);
    return w;
  }
};

// The stage-1 block: threads for the modality that wants most, and the
// largest shared memory of any modality's layout at that count.
inline size_t lstm_block(const Args& a, size_t esize, int* threads) {
  int th = 0;
  for (int m = 0; m < a.n_mods; ++m) {
    const int H = a.hid[m];
    const int n = round_up(H * lanes_per_unit(H, kMaxThreads), 32);
    th = n > th ? n : th;
  }
  size_t s = 0;
  for (int m = 0; m < a.n_mods; ++m) {
    const size_t sm = LstmLayout(a.hid[m], th).bytes(a.hid[m], esize);
    s = sm > s ? sm : s;
  }
  *threads = th;
  return s;
}

template <typename T>
int run(const Args& a, void* ws, cudaStream_t st) {
  const size_t es = sizeof(T);
  // kernel 6: every c_t stored, and the dropout unless both rates are 0
  const bool store_c = a.cs != nullptr;
  const bool drop = a.seeds != nullptr && (a.thr1 != 0u || a.thr2 != 0u);
  Carver c{static_cast<char*>(ws)};
  const Work w = Work::carve(c, a);
  const int CW = a.c_width, K = 2 * CW;  // K: the width of c*
  const int M = a.B * (a.T + 1) - 1;  // rows (b, t), t <= T; rows with t = T are not read
  auto W = [&](int i) { return static_cast<const T*>(a.g[i]); };

  // stage 1
  int th1 = 0;
  const size_t sm1 = lstm_block(a, es, &th1);
  void (*lstm)(Args, float*) = store_c ? lstm_scan_kernel<T, true> : lstm_scan_kernel<T, false>;
  cudaError_t err =
      cudaFuncSetAttribute(lstm, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm1);
  if (err != cudaSuccess) return (int)err;
  lstm<<<dim3(a.B, a.n_mods), th1, sm1, st>>>(a, w.cs);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // stage 2: row m of A is c* = the K floats at cs + m CW
  const int h1 = a.h_att1, h2 = a.h_att2, R = a.h_g1 + a.h_g2;
  const int* ld = a.g_ld;
  const FfJob<T> att1_fc1{W(0), ld[0], h1, {w.hid, h1, W(1), mfn::kRelu}};
  ff_gemm<T>(w.cs, CW, M, K, &att1_fc1, 1, st);
  const FfJob<T> att1_fc2{W(2), ld[2], K, {w.att, K, W(3), mfn::kNone}};
  ff_gemm<T>(w.hid, h1, M, h1, &att1_fc2, 1, st);
  attend_kernel<<<(M + 7) / 8, 256, 0, st>>>(w.att, w.cs, M, CW);
  const FfJob<T> on_attended[3] = {{W(4), ld[4], h2, {w.hid, h2, W(5), mfn::kRelu}},
                                   {W(8), ld[8], a.h_g1, {w.P, R, W(9), mfn::kNone}},
                                   {W(12), ld[12], a.h_g2, {w.P + a.h_g1, R, W(13), mfn::kNone}}};
  ff_gemm<T>(w.att, K, M, K, on_attended, 3, st);
  const FfJob<T> att2_fc2{W(6), ld[6], a.mem, {w.chat, a.mem, W(7), mfn::kTanh}};
  ff_gemm<T>(w.hid, h2, M, h2, &att2_fc2, 1, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // stage 3: the gamma fc1 mem columns follow the K attended ones
  const MemArgs ma{{W(8) + K, W(12) + K}, {a.g[10], a.g[14]}, {a.g[11], a.g[15]}, w.P, w.chat,
                   a.mems, a.T, a.mem, a.h_g1, a.h_g2, {ld[8], ld[12]}, {ld[10], ld[14]},
                   a.seeds, {a.thr1, a.thr2}, {a.keep1, a.keep2}};
  const int th3 = mem_threads(a.mem, a.h_g1, a.h_g2);
  const MemLayout L(a.mem, a.h_g1, a.h_g2, es);
  void (*mem_scan)(MemArgs) = drop ? mem_scan_kernel<T, true> : mem_scan_kernel<T, false>;
  err = cudaFuncSetAttribute(mem_scan, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L.total);
  if (err != cudaSuccess) return (int)err;
  mem_scan<<<a.B, th3, L.total, st>>>(ma);
  return (int)cudaGetLastError();
}

int launch(const Args& a, int dtype, void* ws, cudaStream_t st) {
  return dtype == kF32 ? run<float>(a, ws, st) : run<__nv_bfloat16>(a, ws, st);
}

// Whether the stages take these widths: a block of at most 1,024 threads per
// scan (512 for the fp32 LSTM scan), each scan's shared memory within the
// opt-in limit, and a GEMM grid within 65,535 row tiles.
inline bool fits(const Args& a, size_t esize) {
  int th1 = 0;
  const size_t sm1 = lstm_block(a, esize, &th1);
  const long long M = (long long)a.B * (a.T + 1) - 1;
  const int max1 = esize == sizeof(float) ? lstm_max_threads<float>()
                                          : lstm_max_threads<__nv_bfloat16>();
  if (th1 > max1 || sm1 > kSmemMax || mem_threads(a.mem, a.h_g1, a.h_g2) > kMaxThreads)
    return false;
  const MemLayout L(a.mem, a.h_g1, a.h_g2, esize);
  return L.total <= kSmemMax && (M + FBM - 1) / FBM <= 65535;
}

bool parse(Args& a, int dtype, const void* xp, const void* whh, const void* hid, int n_mods,
           const void* gates, int B, int T, int mem, int h_att1, int h_att2, int h_g1,
           int h_g2) {
  if (dtype != kF32 && dtype != kBF16) return false;
  if (!mfn::fill_args(a, xp, whh, hid, n_mods, gates, B, T, mem, h_att1, h_att2, h_g1, h_g2))
    return false;
  for (int m = 0; m < n_mods; ++m)
    if (a.hid[m] < 2 || a.hid[m] % 2) return false;
  const int ws[5] = {mem, h_att1, h_att2, h_g1, h_g2};
  for (int v : ws)
    if (v < 2 || v % 2) return false;
  return fits(a, dtype == kF32 ? sizeof(float) : sizeof(__nv_bfloat16));
}

}  // namespace mfn_staged
}  // namespace mmtx

// Bytes of fp32 workspace mmtx_mfn_scan and mmtx_mfn_train_fwd need (c_width
// the total hidden size), or rows 8 and 9 (mmtx_mfn_scan_packed / _aligned,
// c_width their c row's), or -1 for shapes they refuse.
// hid: host array of n_mods hidden sizes.
extern "C" long long mmtx_mfn_scan_workspace(int dtype, const void* hid, int n_mods, int B,
                                             int T, int mem, int h_att1, int h_att2, int h_g1,
                                             int h_g2, int c_width) {
  using namespace mmtx;
  const void* none[mfn::kMaxMods] = {nullptr, nullptr, nullptr, nullptr};
  const void* gates[16] = {};
  mfn::Args a;
  if (!mfn_staged::parse(a, dtype, none, none, hid, n_mods, gates, B, T, mem, h_att1, h_att2,
                         h_g1, h_g2) ||
      c_width < a.total_h)
    return -1;
  a.c_width = c_width;
  Carver c{nullptr};
  mfn_staged::Work::carve(c, a);
  return (long long)c.used;
}

// C entry.  xp/whh: host arrays of n_mods device pointers; hid: host array of
// n_mods hidden sizes; gates: host array of 16 device pointers (see
// mfn::Args); ws: mmtx_mfn_scan_workspace bytes.  Launches the three stages
// on the stream; returns the first CUDA error, or cudaErrorInvalidValue for
// shapes the kernels refuse.
extern "C" int mmtx_mfn_scan(int dtype, const void* xp, const void* whh, const void* hid,
                             int n_mods, const void* gates, void* hs, void* mems, void* ws,
                             int B, int T, int mem, int h_att1, int h_att2, int h_g1, int h_g2,
                             void* stream) {
  using namespace mmtx;
  mfn::Args a;
  if (!mfn_staged::parse(a, dtype, xp, whh, hid, n_mods, gates, B, T, mem, h_att1, h_att2,
                         h_g1, h_g2))
    return (int)cudaErrorInvalidValue;
  a.hs = hs;
  a.mems = mems;
  return mfn_staged::launch(a, dtype, ws, static_cast<cudaStream_t>(stream));
}
