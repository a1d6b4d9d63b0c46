// Kernel B: the whole T-step Memory Fusion Network recurrence in one launch,
// eval mode.
//
// Replaces: multimodal_transformer_tpu/ops/pallas/mfn_kernel.py
//   mfn_scan_pallas (body _mfn_kernel).
//
// Per step t, for each modality: LSTMCell hidden-to-hidden with gates i,f,g,o
// on top of the hoisted input projection xp[b, t] (x @ W_ih^T + b_ih + b_hh,
// computed outside); then c* = [c_{t-1}; c_t], att1 (Linear-ReLU-Linear, softmax
// over the FEATURE axis), attended = att * c*, c^ = tanh(att2(attended)),
// gamma1/gamma2 = sigmoid(MLP([attended; mem])), mem = g1 * mem + g2 * c^.
// State and arithmetic are fp32; weights and xp are read in their storage
// dtype; the per-step hidden concat and memory are written in that dtype.
//
// What bounds it on the H100: the recurrence is serial in t and tiny per step
// (B=32 videos x ~0.42 M multiply-adds), so it is latency- and L2-bound, not
// FLOP-bound.  Every block re-reads all gate and hidden-to-hidden weights each
// step: ~1.7 MB in fp32 for A+V+L (0.85 MB in bf16), i.e. ~8.7 GB of L2 reads
// for one B=32, T=160 call in fp32.  At ~64 B/clock of L2 bandwidth per SM that
// traffic, not the arithmetic, sets the step time.
//
// What the design does about it: one thread block per video with a loop over
// t inside the kernel (mfn_common.cuh scan_kernel), so the serial chain never
// leaves the SM; the weight rows are read in warp-owned groups so a step pays
// one L2 round trip per row group.  Packing weights into shared memory across
// a thread-block cluster, or serving several videos per block to amortise
// the weight reads, is later work.

#include "mfn_common.cuh"

// C entry.  xp/whh: host arrays of n_mods device pointers; hid: host array of
// n_mods hidden sizes; gates: host array of 16 device pointers (see Args).
// Returns cudaGetLastError() after the launch.
extern "C" int mmtx_mfn_scan(int dtype, const void* xp, const void* whh,
                             const void* hid, int n_mods, const void* gates,
                             void* hs, void* mems, int B, int T, int mem,
                             int h_att1, int h_att2, int h_g1, int h_g2,
                             void* stream) {
  using namespace mmtx;
  mfn::Args a;
  if (!mfn::fill_args(a, xp, whh, hid, n_mods, gates, B, T, mem, h_att1, h_att2, h_g1,
                      h_g2))
    return (int)cudaErrorInvalidValue;
  a.hs = hs;
  a.mems = mems;
  const size_t smem = mfn::smem_floats(a) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    mfn::scan_kernel<float, false><<<B, mfn::kThreads, smem, st>>>(a);
  } else if (dtype == kBF16) {
    mfn::scan_kernel<__nv_bfloat16, false><<<B, mfn::kThreads, smem, st>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
