// The MFN recurrence's device code: the argument block of every MFN kernel
// (kernels B and 6 in csrc/mfn.cu, kernel 7 in csrc/mfn_train.cu, rows 8
// and 9 in csrc/mfn_variants.cu), and the warp-grouped matrix-vector
// products and feature softmax of rows 8 and 9.
//
// Rows 8 and 9 run one thread block per video with a loop over t inside the
// kernel; h, c, mem and every MLP activation live in shared memory.  A step
// is a chain of dependent matrix-vector phases; in each, a warp owns groups
// of 4 weight rows and issues all of a group's coalesced loads (two elements
// per lane) before the shuffle reductions, so the step costs one L2 round
// trip per row group rather than per row.
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
  // Training only (kernels 6 and 7): cs [B, T, total_h] holds every c_t,
  // and the gamma hiddens take hash dropout with the per-step seeds [T, 2].
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
