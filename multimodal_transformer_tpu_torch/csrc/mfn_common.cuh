// The MFN recurrence's argument block, shared by every MFN kernel (kernels
// B and 6 in csrc/mfn.cu, kernel 7 in csrc/mfn_train.cu, rows 8 and 9 in
// csrc/mfn_variants.cu), with its activations.
#pragma once

#include "gemm.cuh"

namespace mmtx {
namespace mfn {

constexpr int kMaxMods = 4;

struct Args {
  const void* xp[kMaxMods];   // [B, T, 4H_m]
  const void* whh[kMaxMods];  // [4H_m, H_m]
  int hid[kMaxMods];
  int n_mods;
  // att1_w1 att1_b1 att1_w2 att1_b2 att2_w1 att2_b1 att2_w2 att2_b2
  // g1_w1 g1_b1 g1_w2 g1_b2 g2_w1 g2_b1 g2_w2 g2_b2, torch layout [out, in]
  const void* g[16];
  // The layout the stages of kernels B and 6 read (fill_args: the natural
  // one; rows 8 and 9 read their packed and padded tensors in place):
  // W_hh_m's gate k, unit j at row k * whh_gate[m] + j, rows whh_ld[m]
  // apart; weight g[i]'s rows g_ld[i] apart (biases: unused), and gamma
  // fc1's mem columns right after its 2 c_width attended ones; a row of the
  // c workspace c_width floats, modality m's H_m lanes from c_off[m], every
  // other lane 0.  Stage 2 runs at K = 2 c_width.
  int whh_ld[kMaxMods], whh_gate[kMaxMods];
  int g_ld[16];
  int c_width, c_off[kMaxMods];
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

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kRelu: return fmaxf(v, 0.f);
    case kTanh: return tanhf(v);
    case kSigmoid: return sigmoidf(v);
    default: return v;
  }
}

// Fills the shape fields of Args from the C entries' arguments, and the
// natural layout.
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
  a.c_width = a.total_h;
  for (int m = 0, off = 0; m < kMaxMods; off += a.hid[m], ++m) {
    a.whh_ld[m] = a.whh_gate[m] = a.hid[m];
    a.c_off[m] = off;
  }
  const int K = 2 * a.total_h;
  const int ld[16] = {K, 1, h_att1, 1, K, 1, h_att2, 1, K + mem, 1, h_g1, 1, K + mem, 1, h_g2, 1};
  for (int i = 0; i < 16; ++i) a.g_ld[i] = ld[i];
  a.cs = nullptr;
  a.seeds = nullptr;
  a.thr1 = a.thr2 = 0;
  a.keep1 = a.keep2 = 1.f;
  return true;
}

}  // namespace mfn
}  // namespace mmtx
