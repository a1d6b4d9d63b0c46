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

The kernel has two routes, chosen by `route(dtype, N, F, D, E, *pointers)`
from those properties alone, before the launch, and counted in
`launches_by_route`; neither stands in for the other (a route that fails to
build or launch raises):
  * "wgmma" (C entry `mmtx_window_embed_tiled`): bf16 with F - 1 <= 64,
    D % 4 == 0, E % 4 == 0, E <= 320, one tile's shared memory within
    227 KB (the library's plan, `tiled_plan`, decides these), and x and
    the highway's weights 8-byte aligned -- every front end of every
    family but B1's ReLU Highway.  Each window gets R rows (R the power
    of two >= F - 1, rows f >= F - 1 at -inf), each frame is staged once,
    the conv runs on wgmma over every channel against the weight laid out
    as [2, E_pad, D_pad] (`tiled_weight`), the max over frames is taken
    in registers and the bias added after it.
    `window_embed_tiled_plain` is that arithmetic in PyTorch.
  * "tiles" (C entry `mmtx_window_embed`): float32 on the FMA pipes, and
    bf16 outside those conditions (mma.sync over 128-row pair tiles).

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

import ctypes

import torch
import torch.nn.functional as F

from ..basic import conv1d_window_embed, highway_fn
from ..dispatch import acc_dtype, check_kernel_dtype, use_kernel
from . import _build

ROUTE_WGMMA, ROUTE_TILES = "wgmma", "tiles"
# the wgmma route's widths (csrc/window_embed.cu, namespace wembed_tc): E is
# padded to 32 NC channels for NC in TILED_WIDTHS, D to a multiple of
# TILED_BK; its C entry refuses any other padding
TILED_WIDTHS = (1, 2, 3, 8, 10)
TILED_BK = 32
# what `tiled_plan` returns, in mmtx_window_embed_tiled_plan's order
PLAN_KEYS = ("R", "E_pad", "D_pad", "tiles_per_block", "group", "stages",
             "smem")

# Number of kernel launches (one per modality and forward) since the last
# reset, in all and by route.
launches = 0
launches_by_route = {ROUTE_WGMMA: 0, ROUTE_TILES: 0}


def reset_launches() -> None:
    global launches
    launches = 0
    for k in launches_by_route:
        launches_by_route[k] = 0


def tiled_shape(Fr: int, D: int, E: int):
    """The wgmma route's (R, E_pad, D_pad): R rows a window (the power of
    two >= F - 1), E padded to its next instantiated width, D to a multiple
    of TILED_BK.  E_pad is None past the widest (320)."""
    R = 1 << max(0, (Fr - 2).bit_length())
    E_pad = next((32 * nc for nc in TILED_WIDTHS if 32 * nc >= E), None)
    return R, E_pad, -(-D // TILED_BK) * TILED_BK


def tiled_plan(N: int, Fr: int, D: int, E: int):
    """The wgmma route's plan of N windows from the library (csrc/
    window_embed.cu `plan`, the one place its shared-memory sizes live):
    None where the route does not take (F, D, E), else a dict of PLAN_KEYS
    on the current card (a block runs its tiles in groups of `group`)."""
    out = (ctypes.c_int * len(PLAN_KEYS))()
    if not _build.load().mmtx_window_embed_tiled_plan(N, Fr, D, E, out):
        return None
    return dict(zip(PLAN_KEYS, out))


def route(dtype: torch.dtype, N: int, Fr: int, D: int, E: int,
          *ptrs: int) -> str:
    """The kernel route of a call: ROUTE_WGMMA for bf16 with x and the
    highway's weights 8-byte aligned (ptrs their addresses) where the
    library's plan takes the shape (`tiled_plan`: F - 1 <= 64, D % 4 == 0,
    E % 4 == 0, E <= 320, one tile within 227 KB of shared memory);
    ROUTE_TILES otherwise."""
    if dtype != torch.bfloat16 or any(p % 8 for p in ptrs):
        return ROUTE_TILES
    return ROUTE_WGMMA if tiled_plan(N, Fr, D, E) else ROUTE_TILES


def tiled_weight(conv_w: torch.Tensor, E_pad: int, D_pad: int) -> torch.Tensor:
    """The conv weight [E, D, 2] as the wgmma route reads it: [2, E_pad,
    D_pad] contiguous, W0 then W1, zero past E and D (one op: F.pad with no
    padding to add clones the permuted strides, and then `contiguous`
    copies)."""
    E, D, _ = conv_w.shape
    return F.pad(conv_w.permute(2, 0, 1),
                 (0, D_pad - D, 0, E_pad - E)).contiguous()


def window_embed_highway_plain(x, conv_w, conv_b, wp, bp, wg, bg):
    """The kernel's function in plain PyTorch, with its rounding points."""
    acc = acc_dtype(x.dtype)
    pooled = conv1d_window_embed(x.to(acc), conv_w.to(acc), conv_b.to(acc))
    return highway_fn(pooled, wp.to(acc), bp.to(acc), wg.to(acc),
                      bg.to(acc)).to(x.dtype)


def window_embed_tiled_plain(x, conv_w, conv_b, wp, bp, wg, bg):
    """The wgmma route's arithmetic in plain PyTorch: the weight laid out by
    `tiled_weight`, R rows a window (row f pairs frames min(f, F - 2) and
    the next; rows f >= F - 1 at -inf), the max over them, the bias after
    the max, and the highway, with the kernel's rounding points."""
    acc = acc_dtype(x.dtype)
    *lead, Fr, D = x.shape
    E = conv_w.shape[0]
    R, E_pad, D_pad = tiled_shape(Fr, D, E)
    if E_pad is None:
        raise ValueError(f"window_embed_tiled_plain: E={E} is past the "
                         "wgmma route's widest tile (320)")
    w = tiled_weight(conv_w, E_pad, D_pad).to(acc)
    xs = F.pad(x.reshape(-1, Fr, D).to(acc), (0, D_pad - D))
    f = torch.arange(R, device=x.device)
    src = f.clamp(max=Fr - 2)
    conv = xs[:, src] @ w[0].T + xs[:, src + 1] @ w[1].T  # [N, R, E_pad]
    conv = conv.masked_fill((f >= Fr - 1)[None, :, None], float("-inf"))
    pooled = conv.amax(dim=1)[:, :E] + conv_b.to(acc)
    out = highway_fn(pooled, wp.to(acc), bp.to(acc), wg.to(acc), bg.to(acc))
    return out.to(x.dtype).reshape(*lead, E)


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
    r = route(x.dtype, N, Fr, D, E, x.data_ptr(), wp.data_ptr(),
              wg.data_ptr())
    lib = _build.load()
    if r == ROUTE_WGMMA:
        _, E_pad, D_pad = tiled_shape(Fr, D, E)
        wt = tiled_weight(conv_w, E_pad, D_pad)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.mmtx_window_embed_tiled(
                x.data_ptr(), wt.data_ptr(), conv_b.data_ptr(), wp.data_ptr(),
                bp.data_ptr(), wg.data_ptr(), bg.data_ptr(), out.data_ptr(),
                N, Fr, D, E, E_pad, D_pad, stream)
    else:
        # the conv weight as [E, 2D] = [W0 | W1]: the kernel's pair rows
        # [x[f], x[f+1]] then meet contiguous weight rows
        kcat = torch.cat([conv_w[:, :, 0], conv_w[:, :, 1]], dim=1)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.mmtx_window_embed(
                dtype_code, x.data_ptr(), kcat.data_ptr(), conv_b.data_ptr(),
                wp.data_ptr(), bp.data_ptr(), wg.data_ptr(), bg.data_ptr(),
                out.data_ptr(), N, Fr, D, E, stream)
    _build.check(rc, f"window_embed_highway ({r} route)")
    launches += 1
    launches_by_route[r] += 1
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
