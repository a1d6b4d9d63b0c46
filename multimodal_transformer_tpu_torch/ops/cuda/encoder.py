"""Kernel A: the fused key-masked encoder stack (csrc/encoder.cu).

Counterpart of `multimodal_transformer_tpu/ops/pallas/encoder.py`
`encoder_stack_fused`.  `encoder_stack_fused` launches the CUDA kernel for a
CUDA tensor and runs `encoder_stack_fused_plain` for a CPU tensor.  The plain
version keeps the kernel's rounding points: matmul inputs in the storage
dtype with float32 accumulation; LayerNorm, softmax and the residual stream
in float32; q (pre-scaled by 1/sqrt(d_k)), k, v, the attention output, the
FFN hidden and p in p @ v stored in the storage dtype; keys masked with
-1e9, query rows not masked.  With float64 inputs it computes everything in
float64 (the reference for error bounds).  Rows past a video's length are
garbage and compared nowhere.

The kernel has two paths, chosen by `kernel_path(dtype, d_k, D, F)` and
passed to the C entry, which refuses any other: the FMA pipes (float32, and
bf16 at d_k < 16 or at widths the wgmma tiling does not take) and wgmma
(bf16 at d_k in {16, 32}, D in {128, 256} and F = 128: the encoders' D =
256, h = 8, F = 128).  None stands in for another: a path that fails to build
or launch raises.  The wgmma path's attention holds a (video, head)'s K and
V whole in shared memory: `check_attention_fit` refuses a T that does not
fit, and `key_tiles` cuts its key row into the score tiles the kernel
takes.
"""

from __future__ import annotations

import torch

from ..dispatch import check_kernel_dtype, check_no_grad, use_kernel
from ..norm import layer_norm
from . import _build

NEG_INF = -1e9
SUPPORTED_DK = (2, 4, 8, 16, 32)
# the kernel's paths (csrc/encoder.cu, the C entry's `path`)
PATH_FMA, PATH_WGMMA = 0, 1
WGMMA_DK = (16, 32)
WGMMA_D = (128, 256)  # D of the wgmma path
WGMMA_F = 128  # its FFN width: the only one a configuration uses
# a block's dynamic shared memory on the H100 (227 KB)
SMEM_LIMIT = 232448

# Number of kernel launches (one per encoder stack) since the last reset.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def kernel_path(dtype: torch.dtype, d_k: int, D: int, F: int) -> int:
    """The kernel path of (dtype, d_k, D, F): PATH_WGMMA for bf16 with d_k in
    {16, 32}, D in {128, 256} and F = 128; PATH_FMA for float32 and other
    bf16 widths."""
    if d_k not in SUPPORTED_DK:
        raise ValueError(f"encoder_stack_fused: d_k={d_k} not in "
                         f"{SUPPORTED_DK}")
    if dtype == torch.float32:
        return PATH_FMA
    if dtype != torch.bfloat16:
        raise TypeError(f"encoder_stack_fused: no kernel path for {dtype}")
    if d_k in WGMMA_DK and D in WGMMA_D and F == WGMMA_F:
        return PATH_WGMMA
    return PATH_FMA


def key_tiles(T: int) -> tuple:
    """(tiles, keys a tile) of the wgmma path's attention over T keys: one
    tile of 64 * ceil(T / 64) keys up to T = 256 (one softmax max over the
    whole row); past it the fewest tiles of at most 256 keys, balanced, with
    an online softmax across them.  Tiles are multiples of 64 keys."""
    if T < 1:
        raise ValueError(f"encoder_stack_fused: T={T} < 1")
    sub = -(-T // (64 * -(-T // 256)))
    return -(-T // (64 * sub)), 64 * sub


def attention_smem_bytes(T: int, d_k: int) -> int:
    """Shared memory of a wgmma-path attention block: K and V of one
    (video, head) in bf16 and its keys' fp32 mask, padded to whole tiles,
    the barrier and 1 KB of alignment slack (csrc/encoder.cu
    enc_wgmma::attention_smem)."""
    tiles, keys = key_tiles(T)
    return tiles * keys * (2 * d_k * 2 + 4) + 8 + 1024


def check_attention_fit(T: int, d_k: int) -> None:
    """Raises when the wgmma path's attention block cannot hold a (video,
    head)'s K and V: T past 1,536 at d_k = 32 (3,328 at 16)."""
    need = attention_smem_bytes(T, d_k)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"encoder_stack_fused: T={T}, d_k={d_k} needs {need} bytes of "
            f"shared memory for K and V, over the {SMEM_LIMIT} a block has; "
            "the encoder route takes the flash route past T = 512")


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
    if torch.is_grad_enabled():
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
    F = enc.layers[0].feed_forward.w_1.weight.shape[0] if enc.layers else 128
    path = kernel_path(x.dtype, D // h, D, F)
    key_sub = 0
    if path == PATH_WGMMA:
        check_attention_fit(T, D // h)
        key_sub = key_tiles(T)[1] // 64
    align = 16 if path == PATH_WGMMA else 1  # cp.async and TMA take 16 bytes
    if not x.is_contiguous() or x.data_ptr() % align:
        raise ValueError(f"encoder_stack_fused: x must be contiguous and "
                         f"{align}-byte aligned")
    if mask.device != x.device:
        raise ValueError("encoder_stack_fused: mask and x on different devices")
    layer_ts = [t for layer in enc.layers for t in _layer_tensors(layer)]
    fnorm = [enc.norm.a_2, enc.norm.b_2]
    for t in layer_ts + fnorm:
        if t.device != x.device or t.dtype != x.dtype or \
                not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(
                "encoder_stack_fused: every parameter must be contiguous, "
                f"{align}-byte aligned, on {x.device} and in {x.dtype}; "
                f"got {t.dtype} on {t.device}")
    ptrs = _build.pointer_array([t.data_ptr() for t in layer_ts])
    M = B * T
    kmask = mask[..., 0].to(torch.float32).contiguous()
    out = torch.empty_like(x)
    # one workspace: xres fp32 [M, D], then qkv [M, 3D], attn [M, D] and
    # (FMA path) mid [M, F] and xn [M, D] in x's dtype, each 256-byte aligned
    es = x.element_size()
    fma = path == PATH_FMA
    sizes = [4 * M * D, es * 3 * M * D, es * M * D, es * M * F * fma,
             es * M * D * fma]
    offs = [0]
    for n in sizes[:-1]:
        offs.append(offs[-1] + -(-n // 256) * 256)
    ws = torch.empty(offs[-1] + sizes[-1], dtype=torch.uint8, device=x.device)
    xres, qkv, attn, mid, xn = (ws.data_ptr() + o for o in offs)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mmtx_encoder_stack(
            path, dtype_code, x.data_ptr(), kmask.data_ptr(), out.data_ptr(),
            ptrs, len(enc.layers), fnorm[0].data_ptr(), fnorm[1].data_ptr(),
            xres, xn, qkv, attn, mid, B, T, D, h, F, key_sub, stream)
    _build.check(rc, "encoder_stack_fused")
    launches += 1
    return out
