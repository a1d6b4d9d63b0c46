// Kernels 4 and 5 on wgmma (csrc/encoder_bwd.cu): the entries that
// encoder_train.cu's C entries take for the shapes `takes` accepts.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mmtx {
namespace enc_bwd {

// Whether the wgmma path takes the layer: bf16 at d_k in {16, 32}, D in
// {128, 256} and F = 128.
bool takes(int dtype, int D, int H, int F);

// Workspace bytes of one layer's backward (stack: also the two fp32 [B, T,
// D] buffers that carry dy between layers).
long long workspace_bytes(int B, int T, int D, int H, int F, bool stack);

// Kernel 4 (one layer) and kernel 5 (every layer, last first), with the
// arguments of the C entries mmtx_encoder_layer_bwd / mmtx_encoder_stack_bwd.
int layer_bwd(const float* x, const float* dy, const float* kmask, const void* const* lp,
              const uint32_t* seeds, uint32_t thr, float kp, int t8, float* dx,
              void* const* gp, void* ws, int B, int T, int D, int H, int F, cudaStream_t st);
int stack_bwd(const float* saved, const float* dy, const float* kmask, const void* const* lp,
              int n_layers, const uint32_t* seeds, uint32_t thr, float kp, int t8, float* dx,
              void* const* gp, void* ws, int B, int T, int D, int H, int F, cudaStream_t st);

}  // namespace enc_bwd
}  // namespace mmtx
