// Rows 8 and 9: kernel B's function (csrc/mfn.cu), the whole T-step MFN
// recurrence in eval mode, hs [B, T, total_h] and mems [B, T, mem] with fp32
// state, on the TPU kernels' two other weight layouts, read in place.
//
// Replaces: multimodal_transformer_tpu/ops/pallas/mfn_kernel.py
//   mfn_scan_pallas_packed (body _mfn_kernel_packed, packing
//   pack_mfn_params_blockdiag) and mfn_scan_pallas_aligned (body
//   _mfn_kernel_aligned, packing pack_mfn_params_aligned).
//
// Both entries launch kernel B's three stages (mfn_staged::launch: the LSTM
// scan, the batched products and feature softmax, the memory scan) on
// views of the packed or padded tensors that the wrapper
// (ops/cuda/mfn_variants.py) computes: for each weight a pointer, a row
// stride and, for W_hh, a gate stride (the rows between gates i, f, g and
// o); and the width of a row of the c workspace with each modality's first
// lane in it.  The views are all they receive.
//
// Packed (the block-diagonal W_hh [4TH, TH], w1g [h2 + hg1 + hg2, 2TH +
// mem], w2bd [3 mem, h2 + hg1 + hg2]): modality m's W_hh is the diagonal
// block at row 4 off_m, column off_m, row stride TH, gate stride H_m;
// att2_fc1 and the gamma fc1 layers are w1g's rows 0, h2 and h2 + hg1, row
// stride 2TH + mem; the fc2 layers are w2bd's diagonal blocks.  The zero
// blocks are never read, and the arithmetic and its order are kernel B's:
// the same bits.
//
// Aligned (each modality's hidden block padded to HP_m lanes: W_hh [4 HP_m,
// HP_m], the gate MLPs over the padded c* with zero columns, att1's logits
// with a -1e9 bias on the pad lanes): stage 1 runs the H_m real units of
// each modality, reading W_hh at gate stride HP_m, and writes c into rows of
// THP = sum HP_m lanes, 0 on the pad lanes at every call, so that each c*
// row is the aligned layout's [c_prev; c_new].  Stage 2 runs at K = 2 THP;
// the softmax over 2 THP gives the pad lanes exactly 0.  Stage 3 reads
// gamma fc1's mem columns at 2 THP.
//
// What bounds them on the H100: as kernel B, each scan's step is a short
// serial chain (one block per video or (video, modality), T steps), and
// the batched products run on the FMA pipes; the aligned layout adds its
// pad columns to stage 2's products (K 512 instead of 448 at A+V+L, HP_m a
// multiple of 32).  The TPU layouts only fed its matrix unit fewer, larger
// or lane-aligned products; here they cost nothing but stage 2's pad
// columns.

#include "mfn_staged.cuh"

namespace mmtx {
namespace mfnv {

inline bool on_boundary(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Sets a's layout from the views' C arguments, or returns false for views
// the stages cannot read: a weight off its element's boundary (the stages
// read weights element by element) or an xp off a 16-byte one (the LSTM
// scan copies xp rows 16 bytes at a time); a row stride or gate stride
// shorter than what it holds; modalities' lanes that do not start at lane
// 0, overlap or pass the c row; or pad lanes where `pads` is false.
bool set_views(mfn::Args& a, size_t esize, const void* whh, const void* whh_ld,
               const void* whh_gate, const void* gates, const void* gate_ld, const void* c_off,
               int c_width, bool pads) {
  const void* const* wp = static_cast<const void* const*>(whh);
  const int* wl = static_cast<const int*>(whh_ld);
  const int* wg = static_cast<const int*>(whh_gate);
  const int* co = static_cast<const int*>(c_off);
  int end = 0;
  for (int m = 0; m < a.n_mods; ++m) {
    const int H = a.hid[m];
    if (!on_boundary(wp[m], esize) || !on_boundary(a.xp[m], 16) || wl[m] < H || wg[m] < H ||
        (m == 0 && co[m] != 0) || co[m] < end)
      return false;
    a.whh[m] = wp[m];
    a.whh_ld[m] = wl[m];
    a.whh_gate[m] = wg[m];
    a.c_off[m] = co[m];
    end = co[m] + H;
  }
  if (c_width < end || (!pads && c_width != a.total_h)) return false;
  a.c_width = c_width;
  const int K = 2 * c_width;
  // the columns each weight's rows hold (0: a bias)
  const int cols[16] = {K, 0, a.h_att1, 0, K, 0, a.h_att2, 0,
                        K + a.mem, 0, a.h_g1, 0, K + a.mem, 0, a.h_g2, 0};
  const void* const* gp = static_cast<const void* const*>(gates);
  const int* gl = static_cast<const int*>(gate_ld);
  for (int i = 0; i < 16; ++i) {
    if (!on_boundary(gp[i], esize) || gl[i] < cols[i]) return false;
    a.g[i] = gp[i];
    a.g_ld[i] = gl[i];
  }
  return true;
}

int run(bool pads, int dtype, const void* xp, const void* hid, int n_mods, const void* whh,
        const void* whh_ld, const void* whh_gate, const void* gates, const void* gate_ld,
        const void* c_off, int c_width, void* hs, void* mems, void* ws, int B, int T, int mem,
        int h_att1, int h_att2, int h_g1, int h_g2, void* stream) {
  mfn::Args a;
  if (!mfn_staged::parse(a, dtype, xp, whh, hid, n_mods, gates, B, T, mem, h_att1, h_att2,
                         h_g1, h_g2) ||
      !set_views(a, dtype == kF32 ? sizeof(float) : sizeof(__nv_bfloat16), whh, whh_ld,
                 whh_gate, gates, gate_ld, c_off, c_width, pads))
    return (int)cudaErrorInvalidValue;
  a.hs = hs;
  a.mems = mems;
  return mfn_staged::launch(a, dtype, ws, static_cast<cudaStream_t>(stream));
}

}  // namespace mfnv
}  // namespace mmtx

// C entries, one argument list.  xp: host array of n_mods device pointers
// (unpadded [B, T, 4H_m]); hid: host array of the n_mods hidden sizes; whh:
// host array of n_mods device pointers, each modality's W_hh view, with
// whh_ld and whh_gate (host int arrays) its row and gate strides; gates:
// host array of the 16 gate tensors' views (kernel B's order, see
// mfn::Args), with gate_ld (16 host ints) their row strides; c_off (n_mods
// host ints) and c_width: each modality's first lane and the width of a c
// workspace row; ws: mmtx_mfn_scan_workspace bytes at c_width.  Launch the
// three stages on the stream; return the first CUDA error, or
// cudaErrorInvalidValue for shapes or views the stages refuse.

// Row 8: the packed layout's views (a c row without pad lanes).
extern "C" int mmtx_mfn_scan_packed(int dtype, const void* xp, const void* hid, int n_mods,
                                    const void* whh, const void* whh_ld, const void* whh_gate,
                                    const void* gates, const void* gate_ld, const void* c_off,
                                    int c_width, void* hs, void* mems, void* ws, int B, int T,
                                    int mem, int h_att1, int h_att2, int h_g1, int h_g2,
                                    void* stream) {
  return mmtx::mfnv::run(false, dtype, xp, hid, n_mods, whh, whh_ld, whh_gate, gates, gate_ld,
                         c_off, c_width, hs, mems, ws, B, T, mem, h_att1, h_att2, h_g1, h_g2,
                         stream);
}

// Row 9: the aligned layout's views (pad lanes after each modality's).
extern "C" int mmtx_mfn_scan_aligned(int dtype, const void* xp, const void* hid, int n_mods,
                                     const void* whh, const void* whh_ld, const void* whh_gate,
                                     const void* gates, const void* gate_ld, const void* c_off,
                                     int c_width, void* hs, void* mems, void* ws, int B, int T,
                                     int mem, int h_att1, int h_att2, int h_g1, int h_g2,
                                     void* stream) {
  return mmtx::mfnv::run(true, dtype, xp, hid, n_mods, whh, whh_ld, whh_gate, gates, gate_ld,
                         c_off, c_width, hs, mems, ws, B, T, mem, h_att1, h_att2, h_g1, h_g2,
                         stream);
}
