// Kernel 3's wgmma path (bf16 at d_k in {16, 32}, D in {128, 256} and F =
// 128), the entries that encoder_train.cu's C entry takes: kernel A's row
// chain with the layer's dropout (csrc/encoder.cu, enc_wgmma) around kernel
// 4's attention forward with the site-0 dropout (csrc/encoder_bwd.cu,
// enc_bwd).
#pragma once

#include "hopper.cuh"

namespace mmtx {
namespace enc_bwd {

// Kernel 4's attention forward without its row statistics, on qkv [B, T,
// 3D] through its heads map tm (rows.cuh heads_map), into o [B, T, D].
int train_attention(const CUtensorMap& tm, const __nv_bfloat16* qkv, const float* kmask,
                    __nv_bfloat16* o, int B, int T, int D, int H, Drop site, cudaStream_t st);

}  // namespace enc_bwd

namespace enc_wgmma {

// Kernel 3 (the training forward of a stack of n_layers >= 1), with the
// arguments of the C entry mmtx_encoder_train_fwd; its workspace bytes.
int train_fwd(const __nv_bfloat16* x, const float* kmask, float* out, float* saved,
              const void* const* lp, int n_layers, const uint32_t* seeds, uint32_t thr,
              float kp, int t8, void* ws, int B, int T, int D, int H, int F, cudaStream_t st);
long long train_workspace_bytes(int B, int T, int D);

}  // namespace enc_wgmma
}  // namespace mmtx
