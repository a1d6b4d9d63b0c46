"""Kernel 11: blockwise key-masked attention with an online softmax
(csrc/flash_attention.cu).

Counterpart of `multimodal_transformer_tpu/ops/pallas/attention.py`
`flash_attention_masked` and `flash_attention_trainable`, in their layout:
q [BH, Tq, d_k] and k, v [BH, Tk, d_k], batch and heads flattened.  The key
mask is [BH // h, Tk]: the mask of each video, shared by its h heads (h=1
takes a [BH, Tk] mask), so the repeat over heads is never materialised.

`flash_attention_masked` launches the CUDA kernel for a CUDA tensor and runs
`flash_attention_masked_plain` for a CPU tensor.  The kernel has three
paths, chosen by `kernel_path(dtype, d_k)` and passed to the C entry, which
refuses any other: float32 on the FMA pipes; bf16 with d_k < 16 on
`mma.sync` (a row is under TMA's 16 bytes and `wgmma`'s k depth); bf16
with d_k in {16, 32} through TMA and `wgmma`.  None stands in for another:
a path that fails to build or launch raises.  The plain version is the
dense key-masked attention with the kernel's rounding points: q is
multiplied by 1/sqrt(d_k) in its storage dtype (the scale itself rounded to
that dtype, as the Pallas kernel's `q * scale` takes the Python scale as a
scalar of q's dtype); the scores, softmax and p @ v run in float32 (float64
for float64 inputs, the reference for error bounds); masked keys score
-1e9, so a row whose keys are all masked is the uniform mean of v; query
rows are not masked; the output is rounded to q's dtype.

`FlashAttention` is the autograd Function: its forward is
`flash_attention_masked`; its backward recomputes the plain version under
autograd and returns its VJP, as the JAX package's custom VJP returns that
of its dense attention (there is no backward kernel on either side).
"""

from __future__ import annotations

import math

import torch

from ..dispatch import acc_dtype, check_kernel_dtype, use_kernel
from . import _build

NEG_INF = -1e9
SUPPORTED_DK = (2, 4, 8, 16, 32)
# the kernel's paths (csrc/flash_attention.cu, enum Path)
PATH_FMA, PATH_MMA, PATH_WGMMA = 0, 1, 2

# Number of kernel launches (one per attention call) since the last reset.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def q_scale(d_k: int, dtype: torch.dtype) -> float:
    """1/sqrt(d_k) rounded to dtype: the factor q is multiplied by."""
    return torch.tensor(1.0 / math.sqrt(d_k),
                        dtype=torch.float64).to(dtype).item()


def kernel_path(dtype: torch.dtype, d_k: int) -> int:
    """The kernel path of (dtype, d_k): PATH_FMA for float32, PATH_MMA for
    bf16 with d_k < 16, PATH_WGMMA for bf16 with d_k in {16, 32}."""
    if d_k not in SUPPORTED_DK:
        raise ValueError(f"flash_attention_masked: d_k={d_k} not in "
                         f"{SUPPORTED_DK}")
    if dtype == torch.float32:
        return PATH_FMA
    if dtype == torch.bfloat16:
        return PATH_WGMMA if d_k >= 16 else PATH_MMA
    raise TypeError(f"flash_attention_masked: no kernel path for {dtype}")


def flash_attention_masked_plain(q, k, v, kmask, h: int = 1):
    """The kernel's function in plain PyTorch (see the module docstring)."""
    dt = q.dtype
    acc = acc_dtype(dt)
    BH, Tq, d_k = q.shape
    Tk = k.shape[1]
    qs = (q.to(acc) * q_scale(d_k, dt)).to(dt)
    s = qs.to(acc) @ k.to(acc).transpose(-2, -1)
    keys = kmask.reshape(BH // h, 1, 1, Tk) == 0
    s = s.view(BH // h, h, Tq, Tk).masked_fill(keys, NEG_INF).view(BH, Tq, Tk)
    return (torch.softmax(s, dim=-1) @ v.to(acc)).to(dt)


def _check(q, k, v, kmask, h: int) -> int:
    dtype_code = check_kernel_dtype(q, "flash_attention_masked")
    if q.dim() != 3:
        raise ValueError("flash_attention_masked: q must be [BH, T, d_k], got "
                         f"{tuple(q.shape)}")
    BH, Tq, d_k = q.shape
    Tk = k.shape[1] if k.dim() == 3 else 0
    if d_k not in SUPPORTED_DK:
        raise ValueError(f"flash_attention_masked: d_k={d_k} not in "
                         f"{SUPPORTED_DK}")
    if tuple(k.shape) != (BH, Tk, d_k) or tuple(v.shape) != (BH, Tk, d_k) \
            or Tq < 1 or Tk < 1:
        raise ValueError("flash_attention_masked: k and v must be [BH, Tk, "
                         f"d_k] = [{BH}, Tk >= 1, {d_k}], got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if h < 1 or BH % h or tuple(kmask.shape) != (BH // h, Tk):
        raise ValueError(f"flash_attention_masked: kmask must be [BH // h, Tk] "
                         f"with h={h} dividing BH={BH}, got "
                         f"{tuple(kmask.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype or \
                not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                "flash_attention_masked: q, k and v must be contiguous, "
                f"16-byte aligned, on {q.device} and in {q.dtype}; {name} is "
                f"{t.dtype} on {t.device}, strides {t.stride()}, at "
                f"{t.data_ptr() % 16} bytes past a 16-byte boundary")
    if kmask.device != q.device:
        raise ValueError("flash_attention_masked: kmask and q on different "
                         "devices")
    return dtype_code


def flash_attention_masked(q, k, v, kmask, h: int = 1):
    """Key-masked attention, q [BH, Tq, d_k] fp32 or bf16, k and v
    [BH, Tk, d_k], kmask [BH // h, Tk].  Returns [BH, Tq, d_k] in q's
    dtype."""
    if not use_kernel(q):
        return flash_attention_masked_plain(q, k, v, kmask, h)
    global launches
    dtype_code = _check(q, k, v, kmask, h)
    BH, Tq, d_k = q.shape
    km = kmask.to(torch.float32).contiguous()
    out = torch.empty_like(q)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mmtx_flash_attention(
            kernel_path(q.dtype, d_k), dtype_code, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), km.data_ptr(), out.data_ptr(), BH,
            Tq, k.shape[1], d_k, h, q_scale(d_k, q.dtype), stream)
    _build.check(rc, "flash_attention_masked")
    launches += 1
    return out


class FlashAttention(torch.autograd.Function):
    """apply(q, k, v, kmask, h) -> [BH, Tq, d_k]: the kernel forward, the
    plain version's VJP backward.  kmask and h get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kmask, h=1):
        ctx.save_for_backward(q, k, v, kmask)
        ctx.h = h
        return flash_attention_masked(q, k, v, kmask, h)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[:3]
        q, k, v, kmask = ctx.saved_tensors
        leaves = [t.detach().requires_grad_(n) for t, n in zip((q, k, v), need)]
        with torch.enable_grad():
            y = flash_attention_masked_plain(*leaves, kmask, ctx.h)
            wanted = [t for t, n in zip(leaves, need) if n]
            grads = iter(torch.autograd.grad(y, wanted, g.to(y.dtype)))
        return (*(next(grads) if n else None for n in need), None, None)
