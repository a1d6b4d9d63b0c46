// The MFN recurrence's device code: the argument block of every MFN kernel
// (kernel B in csrc/mfn.cu, kernels 6 and 7 in csrc/mfn_train.cu, rows 8
// and 9 in csrc/mfn_variants.cu), and the warp-grouped matrix-vector
// products and forward step loop of kernel 6 and rows 8 and 9.
//
// One thread block per video with a loop over t inside the kernel; h, c, mem
// and every MLP activation live in shared memory.  A step is a chain of
// dependent matrix-vector phases; in each, a warp owns groups of 4 weight
// rows and issues all of a group's coalesced loads (two elements per lane)
// before the shuffle reductions, so the step costs one L2 round trip per row
// group rather than per row.
#pragma once

#include "gemm.cuh"

namespace mmtx {
namespace mfn {

constexpr int kMaxMods = 4;
constexpr int kThreads = 1024;

struct Args {
  const void* xp[kMaxMods];   // [B, T, 4H_m]
  const void* whh[kMaxMods];  // [4H_m, H_m]
  int hid[kMaxMods];
  int n_mods;
  // att1_w1 att1_b1 att1_w2 att1_b2 att2_w1 att2_b1 att2_w2 att2_b2
  // g1_w1 g1_b1 g1_w2 g1_b2 g2_w1 g2_b1 g2_w2 g2_b2, torch layout [out, in]
  const void* g[16];
  void* hs;    // [B, T, total_h]
  void* mems;  // [B, T, mem]
  int B, T, total_h, mem, h_att1, h_att2, h_g1, h_g2;
  // Training only (kernel 6): cs [B, T, total_h] receives every c_t, and
  // the gamma hiddens take hash dropout with the per-step seeds [T, 2].
  void* cs;
  const uint32_t* seeds;
  uint32_t thr1, thr2;
  float keep1, keep2;
};

enum Act : int { kNone = 0, kRelu = 1, kTanh = 2, kSigmoid = 3 };

// One matrix-vector product of a step: out[r] = act(W[r, :] . x + add[r]).
// W [rows, n] and add [rows] are in the storage dtype (add may be null), x
// and out in smem.
struct Job {
  const void* w;
  const float* x;
  const void* add;
  float* out;
  int n, rows, act;
};

constexpr int kRowsInFlight = 4;

template <typename T> __device__ __forceinline__ float2 load2(const T* p);
template <> __device__ __forceinline__ float2 load2<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <> __device__ __forceinline__ float2 load2<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kRelu: return fmaxf(v, 0.f);
    case kTanh: return tanhf(v);
    case kSigmoid: return sigmoidf(v);
    default: return v;
  }
}

// Runs the jobs' rows in groups of kRowsInFlight per warp: the loads of all
// rows of a group are issued before the shuffle reductions, so a warp waits
// for one L2 round trip per group instead of one per row.  Every n is even
// (checked by the wrappers), so each lane loads two neighbours at a time.
template <typename T>
__device__ void run_jobs(const Job* jobs, int nj, int warp, int nwarps, int lane) {
  int groups = 0;
  for (int j = 0; j < nj; ++j) groups += (jobs[j].rows + kRowsInFlight - 1) / kRowsInFlight;
  for (int g = warp; g < groups; g += nwarps) {
    int j = 0, gg = g;
    while (gg >= (jobs[j].rows + kRowsInFlight - 1) / kRowsInFlight) {
      gg -= (jobs[j].rows + kRowsInFlight - 1) / kRowsInFlight;
      ++j;
    }
    const Job jb = jobs[j];
    const int r0 = gg * kRowsInFlight;
    const int nr = min(kRowsInFlight, jb.rows - r0);
    const T* w = static_cast<const T*>(jb.w) + (size_t)r0 * jb.n;
    float s[kRowsInFlight];
#pragma unroll
    for (int k = 0; k < kRowsInFlight; ++k) s[k] = 0.f;
#pragma unroll 2
    for (int i = 2 * lane; i < jb.n; i += 64) {
      const float x0 = jb.x[i], x1 = jb.x[i + 1];
#pragma unroll
      for (int k = 0; k < kRowsInFlight; ++k) {
        if (k < nr) {
          const float2 wv = load2(w + (size_t)k * jb.n + i);
          s[k] = fmaf(wv.y, x1, fmaf(wv.x, x0, s[k]));
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kRowsInFlight; ++k) s[k] = warp_sum(s[k]);
    if (lane == 0) {
      const T* add = static_cast<const T*>(jb.add);
#pragma unroll
      for (int k = 0; k < kRowsInFlight; ++k)
        if (k < nr)
          jb.out[r0 + k] = activate(s[k] + (add ? to_f(add[r0 + k]) : 0.f), jb.act);
    }
  }
}

// Softmax over n features of one smem vector, written to out; warp 0 reduces
// into red[0] (max) and red[1] (sum).  Needs a __syncthreads() before (x
// complete) and brackets its own reduction with one.
__device__ __forceinline__ void feature_softmax(const float* x, float* out, float* red, int n,
                                                int warp, int lane, int tid, int nthreads) {
  if (warp == 0) {
    float mx = -INFINITY;
    for (int i = lane; i < n; i += 32) mx = fmaxf(mx, x[i]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int i = lane; i < n; i += 32) sum += expf(x[i] - mx);
    sum = warp_sum(sum);
    if (lane == 0) { red[0] = mx; red[1] = sum; }
  }
  __syncthreads();
  for (int i = tid; i < n; i += nthreads) out[i] = expf(x[i] - red[0]) / red[1];
}

// The forward recurrence.  kTrain adds the gamma-hidden dropout (position
// b * width + c of the [B, width] hidden, per-step seeds) and writes c_t.
template <typename T, bool kTrain>
__global__ void __launch_bounds__(kThreads) scan_kernel(Args a) {
  extern __shared__ float sm[];
  const int TH = a.total_h, TH2 = 2 * a.total_h, MEM = a.mem;
  float* h = sm;                    // [TH]
  float* c = h + TH;                // [TH]
  float* cstar = c + TH;            // [2TH]  (c_{t-1} | c_t)
  float* z = cstar + TH2;           // [4TH]  LSTM pre-activations, per modality
  float* a1h = z + 4 * TH;          // [h_att1]
  float* logits = a1h + a.h_att1;   // [2TH]
  float* both = logits + TH2;       // [2TH + MEM]  (attended | mem)
  float* a2h = both + TH2 + MEM;    // [h_att2]
  float* g1h = a2h + a.h_att2;      // [h_g1]
  float* g2h = g1h + a.h_g1;        // [h_g2]
  float* chat = g2h + a.h_g2;       // [MEM]
  float* g1 = chat + MEM;           // [MEM]
  float* g2 = g1 + MEM;             // [MEM]
  float* red = g2 + MEM;            // [2]  softmax max and sum
  float* mem = both + TH2;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  int off[kMaxMods + 1];
  off[0] = 0;
  for (int m = 0; m < a.n_mods; ++m) off[m + 1] = off[m] + a.hid[m];

  for (int i = tid; i < TH; i += blockDim.x) { h[i] = 0.f; c[i] = 0.f; }
  for (int i = tid; i < MEM; i += blockDim.x) mem[i] = 0.f;

  const void* const* gw = a.g;
  T* hs_out = static_cast<T*>(a.hs);
  T* mem_out = static_cast<T*>(a.mems);
  T* cs_out = static_cast<T*>(a.cs);
  Job jobs[kMaxMods];

  for (int t = 0; t < a.T; ++t) {
    __syncthreads();
    // 1. z_m = W_hh_m h_m + xp_m[b, t] for every modality.
    for (int m = 0; m < a.n_mods; ++m) {
      const int H = a.hid[m];
      const T* xp = static_cast<const T*>(a.xp[m]) + ((size_t)b * a.T + t) * 4 * H;
      jobs[m] = Job{a.whh[m], h + off[m], xp, z + 4 * off[m], H, 4 * H, kNone};
    }
    run_jobs<T>(jobs, a.n_mods, warp, nwarps, lane);
    __syncthreads();
    // 2. LSTM cell update (gates i, f, g, o), c* and the hidden output.
    const size_t row = (size_t)b * a.T + t;
    for (int i = tid; i < TH; i += blockDim.x) {
      int m = 0;
      while (i >= off[m + 1]) ++m;
      const int H = a.hid[m], j = i - off[m];
      const float* zm = z + 4 * off[m];
      const float ig = sigmoidf(zm[j]);
      const float fg = sigmoidf(zm[H + j]);
      const float gg = tanhf(zm[2 * H + j]);
      const float og = sigmoidf(zm[3 * H + j]);
      const float c_prev = c[i];
      const float c_new = fg * c_prev + ig * gg;
      const float h_new = og * tanhf(c_new);
      cstar[i] = c_prev;
      cstar[TH + i] = c_new;
      c[i] = c_new;
      h[i] = h_new;
      hs_out[row * TH + i] = from_f<T>(h_new);
      if (kTrain) cs_out[row * TH + i] = from_f<T>(c_new);
    }
    __syncthreads();
    // 3. att1 hidden: relu(W c* + b)
    jobs[0] = Job{gw[0], cstar, gw[1], a1h, TH2, a.h_att1, kRelu};
    run_jobs<T>(jobs, 1, warp, nwarps, lane);
    __syncthreads();
    // 4. att1 logits over the 2TH features
    jobs[0] = Job{gw[2], a1h, gw[3], logits, a.h_att1, TH2, kNone};
    run_jobs<T>(jobs, 1, warp, nwarps, lane);
    __syncthreads();
    // 5. softmax over the feature axis, then attended = att * c*
    feature_softmax(logits, both, red, TH2, warp, lane, tid, blockDim.x);
    for (int i = tid; i < TH2; i += blockDim.x) both[i] *= cstar[i];
    __syncthreads();
    // 6. att2 hidden on attended; gamma1/gamma2 hiddens on [attended; mem]
    jobs[0] = Job{gw[4], both, gw[5], a2h, TH2, a.h_att2, kRelu};
    jobs[1] = Job{gw[8], both, gw[9], g1h, TH2 + MEM, a.h_g1, kRelu};
    jobs[2] = Job{gw[12], both, gw[13], g2h, TH2 + MEM, a.h_g2, kRelu};
    run_jobs<T>(jobs, 3, warp, nwarps, lane);
    __syncthreads();
    if (kTrain) {
      const DropSite s1{a.seeds[2 * t], a.thr1, a.keep1};
      const DropSite s2{a.seeds[2 * t + 1], a.thr2, a.keep2};
      for (int i = tid; i < a.h_g1; i += blockDim.x)
        g1h[i] = s1.apply(g1h[i], (uint32_t)(b * a.h_g1 + i));
      for (int i = tid; i < a.h_g2; i += blockDim.x)
        g2h[i] = s2.apply(g2h[i], (uint32_t)(b * a.h_g2 + i));
      __syncthreads();
    }
    // 7. c^ = tanh(att2 out); gamma1, gamma2 = sigmoid(...)
    jobs[0] = Job{gw[6], a2h, gw[7], chat, a.h_att2, MEM, kTanh};
    jobs[1] = Job{gw[10], g1h, gw[11], g1, a.h_g1, MEM, kSigmoid};
    jobs[2] = Job{gw[14], g2h, gw[15], g2, a.h_g2, MEM, kSigmoid};
    run_jobs<T>(jobs, 3, warp, nwarps, lane);
    __syncthreads();
    // 8. memory update
    for (int i = tid; i < MEM; i += blockDim.x) {
      const float m_new = g1[i] * mem[i] + g2[i] * chat[i];
      mem[i] = m_new;
      mem_out[row * MEM + i] = from_f<T>(m_new);
    }
  }
}

inline size_t smem_floats(const Args& a) {
  const int TH = a.total_h;
  return (size_t)TH * 2 + 2 * TH + 4 * TH + a.h_att1 + 2 * TH + 2 * TH + a.mem +
         a.h_att2 + a.h_g1 + a.h_g2 + 3 * a.mem + 2;
}

// Fills the shape fields of Args from the C entries' arguments.
inline bool fill_args(Args& a, const void* xp, const void* whh, const void* hid, int n_mods,
                      const void* gates, int B, int T, int mem, int h_att1, int h_att2,
                      int h_g1, int h_g2) {
  if (n_mods < 1 || n_mods > kMaxMods || B < 1 || T < 1) return false;
  const void* const* xpp = static_cast<const void* const*>(xp);
  const void* const* whp = static_cast<const void* const*>(whh);
  const int* hp = static_cast<const int*>(hid);
  const void* const* gp = static_cast<const void* const*>(gates);
  a.n_mods = n_mods;
  a.total_h = 0;
  for (int m = 0; m < kMaxMods; ++m) {
    a.xp[m] = m < n_mods ? xpp[m] : nullptr;
    a.whh[m] = m < n_mods ? whp[m] : nullptr;
    a.hid[m] = m < n_mods ? hp[m] : 0;
    a.total_h += a.hid[m];
  }
  for (int i = 0; i < 16; ++i) a.g[i] = gp[i];
  a.B = B; a.T = T; a.mem = mem;
  a.h_att1 = h_att1; a.h_att2 = h_att2; a.h_g1 = h_g1; a.h_g2 = h_g2;
  a.cs = nullptr;
  a.seeds = nullptr;
  a.thr1 = a.thr2 = 0;
  a.keep1 = a.keep2 = 1.f;
  return true;
}

}  // namespace mfn
}  // namespace mmtx
