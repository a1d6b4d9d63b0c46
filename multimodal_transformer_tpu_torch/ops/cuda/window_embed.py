"""Kernel 10: the front end's window embed, Conv1d(k=2) + max over the frames
+ Highway, in one pass (csrc/window_embed.cu).

Counterpart of `multimodal_transformer_tpu/ops/pallas/window_embed.py`
`fused_window_embed_highway` and `window_embed_highway_trainable`.
`window_embed_highway` launches the CUDA kernel for a CUDA tensor and runs
`window_embed_highway_plain` for a CPU tensor.  The plain version keeps the
kernel's rounding points: products of storage-dtype inputs accumulated in
float32, the conv, its max and both highway products in float32, only the
output rounded to x's dtype (float64 throughout for float64 inputs, the
reference for error bounds).

`WindowEmbedHighway` is the autograd Function: its forward is
`window_embed_highway`; its backward recomputes the plain front end
(`conv1d_window_embed` + highway, in the input's dtype) under autograd and
returns its VJP, as the JAX package's custom VJP does.  The recompute picks
its own argmax over the frames, so under bf16 a tie can route a gradient
through another frame than the forward's max did, as on the JAX side.

Arguments: x [..., F, D] with F >= 2; conv_w [E, D, 2]; conv_b [E]; the
highway's projection (wp [E, E], bp [E]) and gate (wg, bg), torch layout.
Returns [..., E].
"""

from __future__ import annotations

import torch

from ..basic import conv1d_window_embed, highway_fn
from ..dispatch import acc_dtype, check_kernel_dtype, use_kernel
from . import _build

# Number of kernel launches (one per modality and forward) since the last
# reset.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def window_embed_highway_plain(x, conv_w, conv_b, wp, bp, wg, bg):
    """The kernel's function in plain PyTorch, with its rounding points."""
    acc = acc_dtype(x.dtype)
    pooled = conv1d_window_embed(x.to(acc), conv_w.to(acc), conv_b.to(acc))
    return highway_fn(pooled, wp.to(acc), bp.to(acc), wg.to(acc),
                      bg.to(acc)).to(x.dtype)


def _check(x, conv_w, conv_b, wp, bp, wg, bg) -> int:
    dtype_code = check_kernel_dtype(x, "window_embed_highway")
    if x.dim() < 2 or x.shape[-2] < 2:
        raise ValueError("window_embed_highway: x must be [..., F, D] with "
                         f"F >= 2 frames for the k=2 conv, got {tuple(x.shape)}")
    D = x.shape[-1]
    E = conv_w.shape[0]
    want = {"conv_w": (E, D, 2), "conv_b": (E,), "wp": (E, E), "bp": (E,),
            "wg": (E, E), "bg": (E,)}
    for (name, shape), t in zip(want.items(), (conv_w, conv_b, wp, bp, wg,
                                                bg)):
        if tuple(t.shape) != shape:
            raise ValueError(f"window_embed_highway: {name} must be {shape} "
                             f"for D={D}, E={E}; got {tuple(t.shape)}")
    for t in (x, conv_w, conv_b, wp, bp, wg, bg):
        if t.device != x.device or t.dtype != x.dtype or not t.is_contiguous():
            raise ValueError(
                "window_embed_highway: every tensor must be contiguous, on "
                f"{x.device} and in {x.dtype}; got {t.dtype} on {t.device}")
    return dtype_code


def window_embed_highway(x, conv_w, conv_b, wp, bp, wg, bg):
    """See the module docstring."""
    if not use_kernel(x):
        return window_embed_highway_plain(x, conv_w, conv_b, wp, bp, wg, bg)
    global launches
    dtype_code = _check(x, conv_w, conv_b, wp, bp, wg, bg)
    *lead, Fr, D = x.shape
    E = conv_w.shape[0]
    N = x.numel() // (Fr * D)
    out = torch.empty((*lead, E), dtype=x.dtype, device=x.device)
    # the conv weight as [E, 2D] = [W0 | W1]: the kernel's pair rows
    # [x[f], x[f+1]] then meet contiguous weight rows
    kcat = torch.cat([conv_w[:, :, 0], conv_w[:, :, 1]], dim=1)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mmtx_window_embed(
            dtype_code, x.data_ptr(), kcat.data_ptr(), conv_b.data_ptr(),
            wp.data_ptr(), bp.data_ptr(), wg.data_ptr(), bg.data_ptr(),
            out.data_ptr(), N, Fr, D, E, stream)
    _build.check(rc, "window_embed_highway")
    launches += 1
    return out


class WindowEmbedHighway(torch.autograd.Function):
    """apply(x, conv_w, conv_b, wp, bp, wg, bg) -> [..., E]: the kernel
    forward, the plain front end's VJP backward."""

    @staticmethod
    def forward(ctx, x, conv_w, conv_b, wp, bp, wg, bg):
        ctx.save_for_backward(x, conv_w, conv_b, wp, bp, wg, bg)
        return window_embed_highway(x, conv_w, conv_b, wp, bp, wg, bg)

    @staticmethod
    def backward(ctx, g):
        # only the inputs that need a gradient become leaves: the front end's
        # x is data, and its gradient would cost a second conv product
        need = ctx.needs_input_grad
        leaves = [t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            x, conv_w, conv_b, wp, bp, wg, bg = leaves
            y = highway_fn(conv1d_window_embed(x, conv_w, conv_b), wp, bp,
                           wg, bg)
            wanted = [t for t, n in zip(leaves, need) if n]
            grads = iter(torch.autograd.grad(y, wanted, g.to(y.dtype)))
        return tuple(next(grads) if n else None for n in need)
