// Two variants of kernel B (csrc/mfn.cu): the same function, the whole T-step
// MFN recurrence in eval mode, hs [B, T, total_h] and mems [B, T, mem] with
// fp32 state, on the TPU kernels' two other weight layouts.
//
// Replaces: multimodal_transformer_tpu/ops/pallas/mfn_kernel.py
//   mfn_scan_pallas_packed (body _mfn_kernel_packed, packing
//   pack_mfn_params_blockdiag) and mfn_scan_pallas_aligned (body
//   _mfn_kernel_aligned, packing pack_mfn_params_aligned).
//
// Packed (5 products a step): one block-diagonal W_hh [4TH, TH] on the
// concatenated hidden state; att1's two layers; att2_fc1, gamma1_fc1 and
// gamma2_fc1 as one [h2 + hg1 + hg2, 2TH + mem] product on [attended; mem]
// (att2's mem columns are zero); their second layers as one block-diagonal
// [3 mem, h2 + hg1 + hg2] product into [c^ | g1 | g2].  The weights come
// packed from the wrapper (ops/cuda/mfn_variants.py) in torch's [out, in]
// layout and are read dense, zero blocks included: 1.62x kernel B's weight
// reads per step at A+V+L.
//
// Aligned: each modality's hidden block padded to HP_m lanes, a multiple of
// 32 (48 -> 64, 88 -> 96, 16 -> 32 at the port's HP = 32; 128 for the TPU's
// layout).  Each modality has its own padded W_hh [4 HP_m, HP_m]; the gate
// MLPs' first layers read the padded c* and [attended; mem] through zero
// columns, and att1's logits carry a -1e9 bias on the pad lanes, so the
// feature softmax gives them exactly 0.  xp is read unpadded: a pad lane's
// pre-activation is 0, so i = f = o = 1/2 and g = 0, which keeps c = h = 0
// there.  A 32-lane chunk lies inside one modality, so in the cell update a
// warp's modality comes from a per-chunk table, with no search.  Only the
// real lanes are written to hs.
//
// What bounds them on the H100: as kernel B, the serial chain of dependent
// matrix-vector phases and the L2 reads of every weight at every step, one
// block per video.  Both variants read more weight bytes than kernel B (the
// zero blocks, the pad rows and columns), so neither is expected to beat it;
// they exist to measure that on this card.  Skipping the zero blocks is
// later work.

#include "mfn_common.cuh"

namespace mmtx {
namespace mfnv {

using mfn::Job;
using mfn::kMaxMods;
using mfn::kNone;
using mfn::kRelu;
using mfn::kSigmoid;
using mfn::kTanh;
using mfn::kThreads;
using mfn::feature_softmax;
using mfn::run_jobs;

struct Packed {
  const void* xp[kMaxMods];  // [B, T, 4H_m], unpadded
  int hid[kMaxMods];
  int n_mods;
  // whh_bd [4TH, TH], a1w1 [h1, 2TH], a1b1, a1w2 [2TH, h1], a1b2,
  // w1g [h2 + hg1 + hg2, 2TH + mem], b1g, w2bd [3 mem, h2 + hg1 + hg2], b2g
  const void* w[9];
  void* hs;    // [B, T, TH]
  void* mems;  // [B, T, mem]
  int B, T, total_h, mem, h_att1, h_att2, h_g1, h_g2;
};

struct Aligned {
  const void* xp[kMaxMods];   // [B, T, 4H_m], unpadded
  const void* whh[kMaxMods];  // [4 HP_m, HP_m]
  int hid[kMaxMods];
  int hp[kMaxMods];
  int n_mods;
  const void* g[16];  // kernel B's 16 gate tensors, padded (mfn_variants.py)
  void* hs;
  void* mems;
  int B, T, total_h, total_hp, mem, h_att1, h_att2, h_g1, h_g2;
};

// Shared memory in floats: kernel B's layout over `width` hidden lanes.
__host__ __device__ inline int smem_floats(int width, int mem, int h1, int h2, int hg1,
                                           int hg2) {
  return 12 * width + h1 + mem + h2 + hg1 + hg2 + 3 * mem + 2;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) packed_kernel(Packed a) {
  extern __shared__ float sm[];
  const int TH = a.total_h, TH2 = 2 * a.total_h, MEM = a.mem;
  const int N3 = a.h_att2 + a.h_g1 + a.h_g2;
  float* h = sm;                    // [TH]
  float* c = h + TH;                // [TH]
  float* cstar = c + TH;            // [2TH]
  float* z = cstar + TH2;           // [4TH]
  float* a1h = z + 4 * TH;          // [h_att1]
  float* logits = a1h + a.h_att1;   // [2TH]
  float* both = logits + TH2;       // [2TH + MEM]
  float* hid3 = both + TH2 + MEM;   // [N3]  att2 | gamma1 | gamma2 hiddens
  float* out3 = hid3 + N3;          // [3 MEM]  c^ | g1 | g2
  float* red = out3 + 3 * MEM;      // [2]
  float* mem = both + TH2;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  int off[kMaxMods + 1];
  off[0] = 0;
  for (int m = 0; m < a.n_mods; ++m) off[m + 1] = off[m] + a.hid[m];
  for (int i = tid; i < TH; i += blockDim.x) { h[i] = 0.f; c[i] = 0.f; }
  for (int i = tid; i < MEM; i += blockDim.x) mem[i] = 0.f;

  const T* whh = static_cast<const T*>(a.w[0]);
  const T* w2bd = static_cast<const T*>(a.w[7]);
  const T* b2g = static_cast<const T*>(a.w[8]);
  T* hs_out = static_cast<T*>(a.hs);
  T* mem_out = static_cast<T*>(a.mems);
  Job jobs[kMaxMods];

  for (int t = 0; t < a.T; ++t) {
    __syncthreads();
    const size_t row = (size_t)b * a.T + t;
    // 1. z = W_hh_bd h + xp: the block-diagonal product, one job per
    //    modality's 4H_m rows (each over all TH columns) for its xp
    for (int m = 0; m < a.n_mods; ++m) {
      const T* xp = static_cast<const T*>(a.xp[m]) + row * 4 * a.hid[m];
      jobs[m] = Job{whh + (size_t)4 * off[m] * TH, h, xp, z + 4 * off[m], TH,
                    4 * a.hid[m], kNone};
    }
    run_jobs<T>(jobs, a.n_mods, warp, nwarps, lane);
    __syncthreads();
    // 2. LSTM cell update, c* and the hidden output (as kernel B)
    for (int i = tid; i < TH; i += blockDim.x) {
      int m = 0;
      while (i >= off[m + 1]) ++m;
      const int H = a.hid[m], j = i - off[m];
      const float* zm = z + 4 * off[m];
      const float c_prev = c[i];
      const float c_new = sigmoidf(zm[H + j]) * c_prev + sigmoidf(zm[j]) * tanhf(zm[2 * H + j]);
      const float h_new = sigmoidf(zm[3 * H + j]) * tanhf(c_new);
      cstar[i] = c_prev;
      cstar[TH + i] = c_new;
      c[i] = c_new;
      h[i] = h_new;
      hs_out[row * TH + i] = from_f<T>(h_new);
    }
    __syncthreads();
    // 3.-4. att1's two layers
    jobs[0] = Job{a.w[1], cstar, a.w[2], a1h, TH2, a.h_att1, kRelu};
    run_jobs<T>(jobs, 1, warp, nwarps, lane);
    __syncthreads();
    jobs[0] = Job{a.w[3], a1h, a.w[4], logits, a.h_att1, TH2, kNone};
    run_jobs<T>(jobs, 1, warp, nwarps, lane);
    __syncthreads();
    // 5. softmax over the feature axis, attended = att * c*
    feature_softmax(logits, both, red, TH2, warp, lane, tid, blockDim.x);
    for (int i = tid; i < TH2; i += blockDim.x) both[i] *= cstar[i];
    __syncthreads();
    // 6. the fused first layers on [attended; mem]
    jobs[0] = Job{a.w[5], both, a.w[6], hid3, TH2 + MEM, N3, kRelu};
    run_jobs<T>(jobs, 1, warp, nwarps, lane);
    __syncthreads();
    // 7. the block-diagonal second layers, one job per activation
    jobs[0] = Job{w2bd, hid3, b2g, out3, N3, MEM, kTanh};
    jobs[1] = Job{w2bd + (size_t)MEM * N3, hid3, b2g + MEM, out3 + MEM, N3, MEM, kSigmoid};
    jobs[2] = Job{w2bd + (size_t)2 * MEM * N3, hid3, b2g + 2 * MEM, out3 + 2 * MEM, N3, MEM,
                  kSigmoid};
    run_jobs<T>(jobs, 3, warp, nwarps, lane);
    __syncthreads();
    // 8. memory update
    for (int i = tid; i < MEM; i += blockDim.x) {
      const float m_new = out3[MEM + i] * mem[i] + out3[2 * MEM + i] * out3[i];
      mem[i] = m_new;
      mem_out[row * MEM + i] = from_f<T>(m_new);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) aligned_kernel(Aligned a) {
  extern __shared__ float sm[];
  const int TP = a.total_hp, TP2 = 2 * a.total_hp, MEM = a.mem;
  float* h = sm;                    // [TP]  padded per modality
  float* c = h + TP;                // [TP]
  float* cstar = c + TP;            // [2TP]
  float* z = cstar + TP2;           // [4TP]
  float* a1h = z + 4 * TP;          // [h_att1]
  float* logits = a1h + a.h_att1;   // [2TP]
  float* both = logits + TP2;       // [2TP + MEM]
  float* a2h = both + TP2 + MEM;    // [h_att2]
  float* g1h = a2h + a.h_att2;      // [h_g1]
  float* g2h = g1h + a.h_g1;        // [h_g2]
  float* chat = g2h + a.h_g2;       // [MEM]
  float* g1 = chat + MEM;           // [MEM]
  float* g2 = g1 + MEM;             // [MEM]
  float* red = g2 + MEM;            // [2]
  int* chunk_mod = reinterpret_cast<int*>(red + 2);  // [TP / 32]
  float* mem = both + TP2;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  int off[kMaxMods + 1], offp[kMaxMods + 1];
  off[0] = offp[0] = 0;
  for (int m = 0; m < a.n_mods; ++m) {
    off[m + 1] = off[m] + a.hid[m];
    offp[m + 1] = offp[m] + a.hp[m];
  }
  for (int m = 0; m < a.n_mods; ++m)
    for (int k = offp[m] / 32 + tid; k < offp[m + 1] / 32; k += blockDim.x) chunk_mod[k] = m;
  for (int i = tid; i < TP; i += blockDim.x) { h[i] = 0.f; c[i] = 0.f; }
  for (int i = tid; i < MEM; i += blockDim.x) mem[i] = 0.f;

  const void* const* gw = a.g;
  T* hs_out = static_cast<T*>(a.hs);
  T* mem_out = static_cast<T*>(a.mems);
  Job jobs[kMaxMods];

  for (int t = 0; t < a.T; ++t) {
    __syncthreads();
    const size_t row = (size_t)b * a.T + t;
    // 1. z_m = W_hh_m h_m over the padded lanes; xp is added in step 2
    for (int m = 0; m < a.n_mods; ++m)
      jobs[m] = Job{a.whh[m], h + offp[m], nullptr, z + 4 * offp[m], a.hp[m], 4 * a.hp[m],
                    kNone};
    run_jobs<T>(jobs, a.n_mods, warp, nwarps, lane);
    __syncthreads();
    // 2. LSTM cell update on every padded lane; the warp's modality from
    //    its chunk (uniform across the warp)
    for (int i = tid; i < TP; i += blockDim.x) {
      const int m = chunk_mod[i >> 5];
      const int H = a.hid[m], HP = a.hp[m], j = i - offp[m];
      const float* zm = z + 4 * offp[m];
      float zi = zm[j], zf = zm[HP + j], zg = zm[2 * HP + j], zo = zm[3 * HP + j];
      if (j < H) {
        const T* xp = static_cast<const T*>(a.xp[m]) + row * 4 * H;
        zi += to_f(xp[j]);
        zf += to_f(xp[H + j]);
        zg += to_f(xp[2 * H + j]);
        zo += to_f(xp[3 * H + j]);
      }
      const float c_prev = c[i];
      const float c_new = sigmoidf(zf) * c_prev + sigmoidf(zi) * tanhf(zg);
      const float h_new = sigmoidf(zo) * tanhf(c_new);
      cstar[i] = c_prev;
      cstar[TP + i] = c_new;
      c[i] = c_new;
      h[i] = h_new;
      if (j < H) hs_out[row * a.total_h + off[m] + j] = from_f<T>(h_new);
    }
    __syncthreads();
    // 3.-8. kernel B's gate MLPs on the padded layout
    jobs[0] = Job{gw[0], cstar, gw[1], a1h, TP2, a.h_att1, kRelu};
    run_jobs<T>(jobs, 1, warp, nwarps, lane);
    __syncthreads();
    jobs[0] = Job{gw[2], a1h, gw[3], logits, a.h_att1, TP2, kNone};
    run_jobs<T>(jobs, 1, warp, nwarps, lane);
    __syncthreads();
    feature_softmax(logits, both, red, TP2, warp, lane, tid, blockDim.x);
    for (int i = tid; i < TP2; i += blockDim.x) both[i] *= cstar[i];
    __syncthreads();
    jobs[0] = Job{gw[4], both, gw[5], a2h, TP2, a.h_att2, kRelu};
    jobs[1] = Job{gw[8], both, gw[9], g1h, TP2 + MEM, a.h_g1, kRelu};
    jobs[2] = Job{gw[12], both, gw[13], g2h, TP2 + MEM, a.h_g2, kRelu};
    run_jobs<T>(jobs, 3, warp, nwarps, lane);
    __syncthreads();
    jobs[0] = Job{gw[6], a2h, gw[7], chat, a.h_att2, MEM, kTanh};
    jobs[1] = Job{gw[10], g1h, gw[11], g1, a.h_g1, MEM, kSigmoid};
    jobs[2] = Job{gw[14], g2h, gw[15], g2, a.h_g2, MEM, kSigmoid};
    run_jobs<T>(jobs, 3, warp, nwarps, lane);
    __syncthreads();
    for (int i = tid; i < MEM; i += blockDim.x) {
      const float m_new = g1[i] * mem[i] + g2[i] * chat[i];
      mem[i] = m_new;
      mem_out[row * MEM + i] = from_f<T>(m_new);
    }
  }
}

constexpr size_t kSmemLimit = 48 * 1024;

template <typename A>
bool fill_common(A& a, const void* xp, const void* hid, int n_mods, int B, int T, int mem,
                 int h_att1, int h_att2, int h_g1, int h_g2) {
  if (n_mods < 1 || n_mods > kMaxMods || B < 1 || T < 1) return false;
  const void* const* xpp = static_cast<const void* const*>(xp);
  const int* hp = static_cast<const int*>(hid);
  a.n_mods = n_mods;
  a.total_h = 0;
  for (int m = 0; m < kMaxMods; ++m) {
    a.xp[m] = m < n_mods ? xpp[m] : nullptr;
    a.hid[m] = m < n_mods ? hp[m] : 0;
    a.total_h += a.hid[m];
  }
  a.B = B; a.T = T; a.mem = mem;
  a.h_att1 = h_att1; a.h_att2 = h_att2; a.h_g1 = h_g1; a.h_g2 = h_g2;
  return true;
}

}  // namespace mfnv
}  // namespace mmtx

// C entries.  xp: host array of n_mods device pointers (unpadded [B, T, 4H_m]);
// hid: host array of the n_mods hidden sizes.  Return cudaGetLastError()
// after the launch.

// weights: host array of the 9 packed device pointers (see mfnv::Packed).
extern "C" int mmtx_mfn_scan_packed(int dtype, const void* xp, const void* hid, int n_mods,
                                    const void* weights, void* hs, void* mems, int B, int T,
                                    int mem, int h_att1, int h_att2, int h_g1, int h_g2,
                                    void* stream) {
  using namespace mmtx;
  mfnv::Packed a;
  if (!mfnv::fill_common(a, xp, hid, n_mods, B, T, mem, h_att1, h_att2, h_g1, h_g2))
    return (int)cudaErrorInvalidValue;
  const void* const* wp = static_cast<const void* const*>(weights);
  for (int i = 0; i < 9; ++i) a.w[i] = wp[i];
  a.hs = hs;
  a.mems = mems;
  const size_t smem =
      sizeof(float) * mfnv::smem_floats(a.total_h, mem, h_att1, h_att2, h_g1, h_g2);
  if (smem > mfnv::kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    mfnv::packed_kernel<float><<<B, mfn::kThreads, smem, st>>>(a);
  } else if (dtype == kBF16) {
    mfnv::packed_kernel<__nv_bfloat16><<<B, mfn::kThreads, smem, st>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// whh: host array of n_mods padded W_hh pointers; hp: host array of the
// padded widths (multiples of 32); gates: host array of the 16 padded gate
// tensors (see mfnv::Aligned).
extern "C" int mmtx_mfn_scan_aligned(int dtype, const void* xp, const void* whh,
                                     const void* hid, const void* hp, int n_mods,
                                     const void* gates, void* hs, void* mems, int B, int T,
                                     int mem, int h_att1, int h_att2, int h_g1, int h_g2,
                                     void* stream) {
  using namespace mmtx;
  mfnv::Aligned a;
  if (!mfnv::fill_common(a, xp, hid, n_mods, B, T, mem, h_att1, h_att2, h_g1, h_g2))
    return (int)cudaErrorInvalidValue;
  const void* const* whp = static_cast<const void* const*>(whh);
  const int* hpp = static_cast<const int*>(hp);
  a.total_hp = 0;
  for (int m = 0; m < mfn::kMaxMods; ++m) {
    a.whh[m] = m < n_mods ? whp[m] : nullptr;
    a.hp[m] = m < n_mods ? hpp[m] : 0;
    if (m < n_mods && (a.hp[m] % 32 != 0 || a.hp[m] < a.hid[m])) return (int)cudaErrorInvalidValue;
    a.total_hp += a.hp[m];
  }
  const void* const* gp = static_cast<const void* const*>(gates);
  for (int i = 0; i < 16; ++i) a.g[i] = gp[i];
  a.hs = hs;
  a.mems = mems;
  const size_t smem =
      sizeof(float) * mfnv::smem_floats(a.total_hp, mem, h_att1, h_att2, h_g1, h_g2) +
      sizeof(int) * (a.total_hp / 32);
  if (smem > mfnv::kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    mfnv::aligned_kernel<float><<<B, mfn::kThreads, smem, st>>>(a);
  } else if (dtype == kBF16) {
    mfnv::aligned_kernel<__nv_bfloat16><<<B, mfn::kThreads, smem, st>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
