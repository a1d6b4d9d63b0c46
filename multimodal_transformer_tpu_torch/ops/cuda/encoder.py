"""Kernel A: the fused key-masked encoder stack (csrc/encoder.cu).

Counterpart of `multimodal_transformer_tpu/ops/pallas/encoder.py`
`encoder_stack_fused`.  `encoder_stack_fused` launches the CUDA kernel for a
CUDA tensor and runs `encoder_stack_fused_plain` for a CPU tensor.  The plain
version keeps the kernel's rounding points: matmul inputs in the storage
dtype with float32 accumulation; LayerNorm, softmax and the residual stream
in float32; q (pre-scaled by 1/sqrt(d_k)), k, v and the attention output
stored in the storage dtype; keys masked with -1e9, query rows not masked.
With float64 inputs it computes everything in float64 (the reference for
error bounds).  Rows past a video's length are garbage and compared nowhere.
"""

from __future__ import annotations

import torch

from ..dispatch import check_kernel_dtype, check_no_grad, use_kernel
from ..norm import layer_norm
from . import _build

NEG_INF = -1e9
SUPPORTED_DK = (2, 4, 8, 16, 32)

# Number of kernel launches (one per encoder stack) since the last reset.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def encoder_stack_fused_plain(enc, x: torch.Tensor, mask: torch.Tensor, *,
                              h: int = 8) -> torch.Tensor:
    """The kernel's function in plain PyTorch.  x [B, T, D]; mask [B, T, 1]."""
    cdt = x.dtype
    acc = torch.float64 if cdt == torch.float64 else torch.float32
    B, T, D = x.shape
    d_k = D // h

    def mm(a, lin):
        w = lin.weight.to(cdt).to(acc)
        return a.to(cdt).to(acc) @ w.T + lin.bias.to(cdt).to(acc)

    def ln(v, norm):
        return layer_norm(v, norm.a_2.to(cdt).to(acc), norm.b_2.to(cdt).to(acc))

    def heads(t):
        return t.to(acc).view(B, T, h, d_k).transpose(1, 2)

    inv_sqrt_dk = 1.0 / torch.tensor(float(d_k), dtype=acc).sqrt().item()
    kmask = mask[..., 0][:, None, None, :]
    xr = x.to(acc)
    for layer in enc.layers:
        lins = layer.self_attn.linears
        xn = ln(xr, layer.sublayer[0].norm).to(cdt)
        q = (mm(xn, lins[0]) * torch.tensor(inv_sqrt_dk, dtype=acc)).to(cdt)
        k = mm(xn, lins[1]).to(cdt)
        v = mm(xn, lins[2]).to(cdt)
        s = heads(q) @ heads(k).transpose(-2, -1)
        s = s.masked_fill(kmask == 0, NEG_INF)
        p = torch.softmax(s, dim=-1).to(cdt).to(acc)
        o = (p @ heads(v)).transpose(1, 2).reshape(B, T, D).to(cdt)
        xr = xr + mm(o, lins[3])
        xn = ln(xr, layer.sublayer[1].norm).to(cdt)
        ff = layer.feed_forward
        mid = torch.relu(mm(xn, ff.w_1)).to(cdt)
        xr = xr + mm(mid, ff.w_2)
    return ln(xr, enc.norm).to(cdt)


def _layer_tensors(layer):
    lins = layer.self_attn.linears
    ff = layer.feed_forward
    n1, n2 = layer.sublayer[0].norm, layer.sublayer[1].norm
    return [n1.a_2, n1.b_2,
            lins[0].weight, lins[0].bias, lins[1].weight, lins[1].bias,
            lins[2].weight, lins[2].bias, lins[3].weight, lins[3].bias,
            n2.a_2, n2.b_2,
            ff.w_1.weight, ff.w_1.bias, ff.w_2.weight, ff.w_2.bias]


def encoder_stack_fused(enc, x: torch.Tensor, mask: torch.Tensor, *,
                        h: int = 8) -> torch.Tensor:
    """Key-masked N-layer encoder stack + final norm.  x [B, T, D] fp32 or
    bf16; mask [B, T, 1].  Returns [B, T, D] in x's dtype.  The kernel has
    no backward: on the card it raises when autograd would record the call
    (`ops/attention.py:encoder_stack` sends such calls to kernels 3 and 4)."""
    if not use_kernel(x):
        return encoder_stack_fused_plain(enc, x, mask, h=h)
    global launches
    check_no_grad("encoder_stack_fused", x, *enc.parameters())
    dtype_code = check_kernel_dtype(x, "encoder_stack_fused")
    if x.dim() != 3:
        raise ValueError(f"encoder_stack_fused: x must be [B, T, D], got "
                         f"{tuple(x.shape)}")
    B, T, D = x.shape
    if tuple(mask.shape) != (B, T, 1):
        raise ValueError(f"encoder_stack_fused: mask must be {(B, T, 1)}, "
                         f"got {tuple(mask.shape)}")
    if D % h or D // h not in SUPPORTED_DK:
        raise ValueError(f"encoder_stack_fused: D={D}, h={h} gives d_k not in "
                         f"{SUPPORTED_DK}")
    if not x.is_contiguous():
        raise ValueError("encoder_stack_fused: x must be contiguous")
    if mask.device != x.device:
        raise ValueError("encoder_stack_fused: mask and x on different devices")
    layer_ts = [t for layer in enc.layers for t in _layer_tensors(layer)]
    fnorm = [enc.norm.a_2, enc.norm.b_2]
    for t in layer_ts + fnorm:
        if t.device != x.device or t.dtype != x.dtype or not t.is_contiguous():
            raise ValueError(
                "encoder_stack_fused: every parameter must be contiguous, on "
                f"{x.device} and in {x.dtype}; got {t.dtype} on {t.device}")
    F = enc.layers[0].feed_forward.w_1.weight.shape[0] if enc.layers else 1
    M = B * T
    kmask = mask[..., 0].to(torch.float32).contiguous()
    out = torch.empty_like(x)
    xres = torch.empty((M, D), dtype=torch.float32, device=x.device)
    xn = torch.empty((M, D), dtype=x.dtype, device=x.device)
    qkv = torch.empty((M, 3 * D), dtype=x.dtype, device=x.device)
    attn = torch.empty((M, D), dtype=x.dtype, device=x.device)
    mid = torch.empty((M, F), dtype=x.dtype, device=x.device)
    ptrs = _build.pointer_array([t.data_ptr() for t in layer_ts])
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mmtx_encoder_stack(
            dtype_code, x.data_ptr(), kmask.data_ptr(), out.data_ptr(), ptrs,
            len(enc.layers), fnorm[0].data_ptr(), fnorm[1].data_ptr(),
            xres.data_ptr(), xn.data_ptr(), qkv.data_ptr(), attn.data_ptr(),
            mid.data_ptr(), B, T, D, h, F, stream)
    _build.check(rc, "encoder_stack_fused")
    launches += 1
    return out
