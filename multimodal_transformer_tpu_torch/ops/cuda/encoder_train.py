"""Kernels 3, 4 and 5: the encoder stack's training forward, one layer's
backward and the whole stack's backward, with in-kernel hash dropout
(csrc/encoder_train.cu).

Counterpart of `multimodal_transformer_tpu/ops/pallas/encoder.py`
`encoder_stack_fused_train` (custom VJP: `_train_fwd_impl`, then either
`_layer_bwd_call` once per layer, last layer first, or `_stack_bwd_call`
once for the stack).  `EncoderStackTrain` is the autograd Function: its
forward runs `encoder_stack_train_fwd` (kernel 3); its backward runs
`encoder_layer_bwd` (kernel 4) per layer on the "perlayer" route, or
`encoder_stack_bwd` (kernel 5) once on the "stack" route.  Kernel 5 computes
the same function as kernel 4 over every layer, in the same order of float
operations, so both routes give the same bits.  Every wrapper launches the
CUDA kernel for a CUDA tensor and runs its plain version for a CPU tensor.

The plain forward keeps the kernel's rounding points: matmul inputs in the
storage dtype with float32 accumulation; LayerNorm, softmax, dropout and the
residual stream in float32; q (pre-scaled by 1/sqrt(d_k)), k, v, the dropped
probabilities, the attention output and the dropped FFN hidden stored in
the storage dtype.  With float64 inputs it computes everything in float64
(the reference for error bounds).  The plain backward of a layer is
`torch.autograd.grad` through the plain forward from the layer's saved
input, with the same keep bits.  In bf16 its gradients round where the TPU
kernel's backward rounds them (`ops/pallas/encoder.py:_layer_bwd_core`) and
nowhere else: dff, dmidp and dattn before their products (their bias
gradients sum the unrounded values), do, dq, dk and dv (their bias
gradients sum the rounded values), ds / sqrt(d_k) before the dq product and
ds before the dk product; the parameters' gradients come back unrounded.
In float32 and float64 every rounding is the identity, as before.  There is
no final norm: the caller applies it, so autograd owns its parameters.

Kernels 3, 4 and 5 have kernel A's two paths, chosen by `kernel_path(dtype,
d_k, D, F)` (ops/cuda/encoder.py) and checked against the C entries' own
choice (`mmtx_encoder_train_fwd_path`, `mmtx_encoder_bwd_path`): wgmma
(bf16 at d_k in {16, 32}, D in {128, 256} and F = 128, at the rounding
points above: kernel 3 is kernel A's row chain with the dropout in its
epilogues around kernel 4's attention forward, csrc/encoder.cu and
csrc/encoder_bwd.cu; kernels 4 and 5 are csrc/encoder_bwd.cu) and the FMA
pipes (float32, and bf16 at other widths: csrc/encoder_train.cu, where the
backward keeps ds in float32).  The wgmma path loads by TMA and 16-byte
cp.async, so it refuses an x or parameters that are not 16-byte aligned.
None stands in for another: a path that fails to build or launch raises.

Dropout sites per layer (seed column): 0 attention probabilities, flat index
over [B, h, T, T]; 1 attention output, 2 FFN hidden, 3 FFN output, flat
index over [B, T, width].  With `hash4=True` (the "hash4" stream) the
seeds give every site whose last axis w is a multiple of 4 (the probabilities'
is T) the multi-bit keep bits of `ops/basic.py hash4_keep` at its (row,
column), row (b*h + head)*T + q or b*T + t; the others keep the hash
bits.  The kernels take the stream as their 8-bit threshold (-1: hash).
"""

from __future__ import annotations

import ctypes

import torch

from ..basic import dropout, hash4_threshold, keep_threshold, site_seed
from ..dispatch import (acc_dtype, check_encoder_backward, check_kernel_dtype,
                        use_kernel)
from ..norm import layer_norm
from . import _build
from .encoder import (NEG_INF, PATH_WGMMA, SUPPORTED_DK, _layer_tensors,
                      kernel_path)

N_PARAMS = 16   # per layer, in _layer_tensors order

# Launches since the last reset: kernel 3 (one per stack), kernel 4 (one per
# layer backward) and kernel 5 (one per stack backward).
fwd_launches = 0
bwd_launches = 0
stack_bwd_launches = 0


def reset_launches() -> None:
    global fwd_launches, bwd_launches, stack_bwd_launches
    fwd_launches = bwd_launches = stack_bwd_launches = 0


class _RoundGrad(torch.autograd.Function):
    """The identity, whose gradient is rounded to bf16 (a rounding point of
    the TPU kernel's backward)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


class _RoundValue(torch.autograd.Function):
    """x rounded to bf16 (as the forward stores it); the gradient passes
    unrounded."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


class _Scores(torch.autograd.Function):
    """s = round(q / sqrt(d_k)) k^T on q before its scale and bf16 k, with
    the TPU kernel's backward: dq = round(ds / sqrt(d_k)) k and dk =
    round(ds)^T round(q / sqrt(d_k))."""

    @staticmethod
    def forward(ctx, q, k, inv_sqrt_dk):
        qs = (q * inv_sqrt_dk).to(torch.bfloat16).to(q.dtype)
        ctx.save_for_backward(qs, k, inv_sqrt_dk)
        return qs @ k.transpose(-2, -1)

    @staticmethod
    def backward(ctx, ds):
        qs, k, inv_sqrt_dk = ctx.saved_tensors
        r = lambda t: t.to(torch.bfloat16).to(ds.dtype)
        return (r(ds * inv_sqrt_dk) @ k, r(ds).transpose(-2, -1) @ qs, None)


def layer_train_plain(lp, x: torch.Tensor, kmask: torch.Tensor, seeds,
                      p: float, h: int, cdt: torch.dtype | None = None,
                      hash4: bool = False) -> torch.Tensor:
    """One layer's forward in plain PyTorch.  lp: the 16 parameters in the
    storage dtype (or upcast copies of them); x: [B, T, D] residual stream in
    the accumulation dtype; kmask [B, T]; seeds: the layer's 4 site seeds;
    cdt: the storage dtype (default: float64 for float64 x, else lp's);
    hash4: the seeds are the "hash4" stream's."""
    (ln1a, ln1b, wq, bq, wk, bk, wv, bv, wo, bo, ln2a, ln2b,
     w1, b1, w2, b2) = lp
    if cdt is None:
        cdt = torch.float64 if x.dtype == torch.float64 else wq.dtype
    acc = x.dtype
    B, T, D = x.shape
    d_k = D // h
    s0, s1, s2, s3 = (site_seed(s, hash4) for s in seeds)
    # bf16 into float32: values rounded where the forward stores them,
    # gradients rounded only at the TPU kernel's backward rounding points
    bf16 = cdt == torch.bfloat16 and acc == torch.float32

    def c(t):
        return _RoundValue.apply(t.to(acc)) if bf16 else t.to(cdt).to(acc)

    def rg(t):
        return _RoundGrad.apply(t) if bf16 else t

    def mm(a, w, b):
        return rg(c(a) @ c(w).T) + c(b)

    def heads(t):
        return c(t).view(B, T, h, d_k).transpose(1, 2)

    inv_sqrt_dk = 1.0 / torch.tensor(float(d_k), dtype=acc).sqrt().item()
    xn = c(layer_norm(x, c(ln1a), c(ln1b)))
    if bf16:  # dq, dk, dv rounded before their bias gradients
        k = rg(mm(xn, wk, bk))
        v = rg(mm(xn, wv, bv))
        split = lambda t: t.view(B, T, h, d_k).transpose(1, 2)
        s = _Scores.apply(split(rg(mm(xn, wq, bq))), heads(k),
                          torch.tensor(inv_sqrt_dk, dtype=acc))
    else:
        q = (mm(xn, wq, bq) * torch.tensor(inv_sqrt_dk, dtype=acc)).to(cdt)
        k = mm(xn, wk, bk).to(cdt)
        v = mm(xn, wv, bv).to(cdt)
        s = heads(q) @ heads(k).transpose(-2, -1)
    s = s.masked_fill(kmask[:, None, None, :] == 0, NEG_INF)
    prob = dropout(torch.softmax(s, dim=-1), s0, p)
    o = (c(prob) @ heads(v)).transpose(1, 2).reshape(B, T, D)
    x1 = x + dropout(mm(rg(o), wo, bo), s1, p)
    xn2 = c(layer_norm(x1, c(ln2a), c(ln2b)))
    mid = c(dropout(torch.relu(mm(xn2, w1, b1)), s2, p))
    return x1 + dropout(mm(mid, w2, b2), s3, p)


def encoder_stack_train_fwd_plain(params, x, kmask, seeds, p: float, h: int,
                                  hash4: bool = False):
    """(out [B, T, D], saved [N, B, T, D]) in the accumulation dtype."""
    xr = x.to(acc_dtype(x.dtype))
    saved = []
    for l in range(len(params) // N_PARAMS):
        saved.append(xr)
        xr = layer_train_plain(params[N_PARAMS * l:N_PARAMS * (l + 1)], xr,
                               kmask, seeds[l], p, h, hash4=hash4)
    return xr, torch.stack(saved)


def encoder_layer_bwd_plain(lp, x_l, dy, kmask, seeds, p: float, h: int,
                            hash4: bool = False):
    """(dx, [16 parameter grads]) of one layer, in the accumulation dtype."""
    acc = x_l.dtype
    with torch.enable_grad():
        x = x_l.detach().requires_grad_()
        # upcast leaves: the grads come back unrounded, like the kernel's;
        # the forward reads them in the storage dtype
        ps = [t.detach().to(acc).requires_grad_() for t in lp]
        y = layer_train_plain(ps, x, kmask, seeds, p, h,
                              cdt=acc if acc == torch.float64 else lp[2].dtype,
                              hash4=hash4)
        grads = torch.autograd.grad(y, [x] + ps, dy)
    return grads[0], list(grads[1:])


def encoder_stack_bwd_plain(params, saved, dy, kmask, seeds, p: float, h: int,
                            hash4: bool = False):
    """Kernel 5's plain version: `encoder_layer_bwd_plain` for every layer,
    last layer first.  Returns (dx, [16 gradients, each stacked over the
    layers as [N, ...]]) in the accumulation dtype."""
    n_layers = saved.shape[0]
    per_layer = [None] * n_layers
    for l in reversed(range(n_layers)):
        dy, per_layer[l] = encoder_layer_bwd_plain(
            params[N_PARAMS * l:N_PARAMS * (l + 1)], saved[l], dy, kmask,
            seeds[l], p, h, hash4)
    return dy, [torch.stack(gs) for gs in zip(*per_layer)]


def _kernel_args(x: torch.Tensor, params, what: str):
    dtype_code = check_kernel_dtype(x, what)
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{what}: x must be a contiguous [B, T, D], got "
                         f"{tuple(x.shape)}")
    B, T, D = x.shape
    if params[2].shape != (D, D):
        raise ValueError(f"{what}: q weight {tuple(params[2].shape)} does not "
                         f"match D={D}")
    for t in params:
        if t.device != x.device or t.dtype != x.dtype or not t.is_contiguous():
            raise ValueError(
                f"{what}: every parameter must be contiguous, on {x.device} "
                f"and in {x.dtype}; got {t.dtype} on {t.device}")
    F = params[12].shape[0]
    return dtype_code, B, T, D, F


def _check_heads(D: int, h: int, what: str) -> None:
    if D % h or D // h not in SUPPORTED_DK:
        raise ValueError(f"{what}: D={D}, h={h} gives d_k not in {SUPPORTED_DK}")


def _hash4_t8(hash4: bool, p: float) -> int:
    """The C entries' stream argument: the 8-bit threshold of the hash4
    stream's multi-bit sites, -1 for the hash stream."""
    return hash4_threshold(p) if hash4 else -1


def _seed_array(seeds) -> ctypes.Array:
    vals = [int(v) & 0xFFFFFFFF for v in torch.as_tensor(seeds).flatten().tolist()]
    return (ctypes.c_uint32 * len(vals))(*vals)


def _check_path(query, dtype_code, tensors, D, h, F, what) -> None:
    """Raises unless the C side (`query`, the library's path entry) takes
    kernel_path's path for the tensors' dtype and the shape; the wgmma
    path loads by TMA and cp.async, so it also needs `tensors` (the
    parameters, and kernel 3's x) 16-byte aligned."""
    path = kernel_path(tensors[0].dtype, D // h, D, F, what=what)
    if query(dtype_code, D, h, F) != path:
        raise RuntimeError(f"{what}: the library's path for D={D}, h={h}, "
                           f"F={F} is not kernel_path's {path}")
    if path == PATH_WGMMA and any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: the wgmma path needs 16-byte aligned "
                         "inputs")


def _workspace(lib, dtype_code, B, T, D, h, F, backward: bool, device):
    n = lib.mmtx_encoder_train_workspace(dtype_code, B, T, D, h, F,
                                         int(backward))
    return torch.empty(n, dtype=torch.uint8, device=device)


def encoder_stack_train_fwd(params, x, kmask, seeds, p: float, h: int,
                            hash4: bool = False):
    """Kernel 3.  params: the stack's 16*N parameters (layer order, each in
    _layer_tensors order); x [B, T, D]; kmask [B, T]; seeds [N, 4]; hash4:
    the seeds are the "hash4" stream's.  Returns (out, saved) in float32
    (float64 for float64 CPU inputs)."""
    if not use_kernel(x):
        return encoder_stack_train_fwd_plain(params, x, kmask, seeds, p, h,
                                             hash4)
    global fwd_launches
    what = "encoder_stack_train_fwd"
    dtype_code, B, T, D, F = _kernel_args(x, params, what)
    _check_heads(D, h, what)
    n_layers = len(params) // N_PARAMS
    if n_layers < 1 or len(params) != N_PARAMS * n_layers:
        raise ValueError(f"{what}: {len(params)} parameters is not 16 per layer")
    if tuple(seeds.shape) != (n_layers, 4):
        raise ValueError(f"{what}: seeds must be [{n_layers}, 4], got "
                         f"{tuple(seeds.shape)}")
    km = kmask.to(device=x.device, dtype=torch.float32).contiguous()
    if tuple(km.shape) != (B, T):
        raise ValueError(f"{what}: kmask must be [{B}, {T}]")
    lib = _build.load()
    _check_path(lib.mmtx_encoder_train_fwd_path, dtype_code, [x, *params], D,
                h, F, what)
    out = torch.empty((B, T, D), dtype=torch.float32, device=x.device)
    saved = torch.empty((n_layers, B, T, D), dtype=torch.float32,
                        device=x.device)
    ws = _workspace(lib, dtype_code, B, T, D, h, F, False, x.device)
    ptrs = _build.pointer_array([t.data_ptr() for t in params])
    seed_arr = _seed_array(seeds)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mmtx_encoder_train_fwd(
            dtype_code, x.data_ptr(), km.data_ptr(), out.data_ptr(),
            saved.data_ptr(), ptrs, n_layers, seed_arr, keep_threshold(p),
            1.0 - p, _hash4_t8(hash4, p), ws.data_ptr(), B, T, D, h, F,
            stream)
    _build.check(rc, what)
    fwd_launches += 1
    return out, saved


def encoder_layer_bwd(lp, x_l, dy, kmask, seeds, p: float, h: int,
                      hash4: bool = False):
    """Kernel 4.  lp: one layer's 16 parameters; x_l: its saved input and dy
    the gradient of its output, [B, T, D] float32; seeds: its 4 site seeds;
    hash4: as kernel 3's.  Returns (dx, [16 parameter grads]) in float32."""
    if not use_kernel(x_l):
        return encoder_layer_bwd_plain(lp, x_l, dy, kmask, seeds, p, h, hash4)
    global bwd_launches
    what = "encoder_layer_bwd"
    if x_l.dtype != torch.float32 or dy.dtype != torch.float32:
        raise TypeError(f"{what}: x_l and dy must be float32")
    if lp[2].dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: parameters must be float32 or bfloat16")
    dtype_code = 0 if lp[2].dtype == torch.float32 else 1
    B, T, D = x_l.shape
    _check_heads(D, h, what)
    if tuple(dy.shape) != (B, T, D) or not (x_l.is_contiguous()
                                            and dy.is_contiguous()):
        raise ValueError(f"{what}: x_l and dy must be contiguous [B, T, D]")
    for t in lp:
        if (t.device != x_l.device or t.dtype != lp[2].dtype
                or not t.is_contiguous()):
            raise ValueError(f"{what}: parameters must be contiguous, on "
                             f"{x_l.device}, in one dtype")
    F = lp[12].shape[0]
    km = kmask.to(device=x_l.device, dtype=torch.float32).contiguous()
    lib = _build.load()
    _check_path(lib.mmtx_encoder_bwd_path, dtype_code, lp, D, h, F, what)
    dx = torch.empty_like(x_l)
    grads = [torch.empty(t.shape, dtype=torch.float32, device=x_l.device)
             for t in lp]
    ws = _workspace(lib, dtype_code, B, T, D, h, F, True, x_l.device)
    ptrs = _build.pointer_array([t.data_ptr() for t in lp])
    gptrs = _build.pointer_array([g.data_ptr() for g in grads])
    seed_arr = _seed_array(seeds)
    with torch.cuda.device(x_l.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mmtx_encoder_layer_bwd(
            dtype_code, x_l.data_ptr(), dy.data_ptr(), km.data_ptr(), ptrs,
            seed_arr, keep_threshold(p), 1.0 - p, _hash4_t8(hash4, p),
            dx.data_ptr(), gptrs, ws.data_ptr(), B, T, D, h, F, stream)
    _build.check(rc, what)
    bwd_launches += 1
    return dx, grads


def _stack_bwd_args(params, saved, dy, kmask, seeds, h: int, what: str):
    """Raises on what kernel 5 cannot take; returns (dtype code, N, B, T, D,
    F, kmask as contiguous float32 on the card)."""
    if saved.dtype != torch.float32 or dy.dtype != torch.float32:
        raise TypeError(f"{what}: saved and dy must be float32")
    if saved.dim() != 4 or not (saved.is_contiguous() and dy.is_contiguous()):
        raise ValueError(f"{what}: saved must be a contiguous [N, B, T, D] and "
                         "dy a contiguous [B, T, D]")
    n_layers, B, T, D = saved.shape
    if tuple(dy.shape) != (B, T, D) or dy.device != saved.device:
        raise ValueError(f"{what}: dy must be [{B}, {T}, {D}] on {saved.device}")
    _check_heads(D, h, what)
    if len(params) != N_PARAMS * n_layers:
        raise ValueError(f"{what}: {len(params)} parameters for {n_layers} "
                         "layers is not 16 per layer")
    dtype = params[2].dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: parameters must be float32 or bfloat16")
    if params[2].shape != (D, D):
        raise ValueError(f"{what}: q weight {tuple(params[2].shape)} does not "
                         f"match D={D}")
    for t in params:
        if t.device != saved.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{what}: parameters must be contiguous, on "
                             f"{saved.device}, in one dtype")
    if tuple(torch.as_tensor(seeds).shape) != (n_layers, 4):
        raise ValueError(f"{what}: seeds must be [{n_layers}, 4]")
    km = kmask.to(device=saved.device, dtype=torch.float32).contiguous()
    if tuple(km.shape) != (B, T):
        raise ValueError(f"{what}: kmask must be [{B}, {T}]")
    return (0 if dtype == torch.float32 else 1, n_layers, B, T, D,
            params[12].shape[0], km)


def encoder_stack_bwd(params, saved, dy, kmask, seeds, p: float, h: int,
                      hash4: bool = False):
    """Kernel 5: the backward of every layer of the stack in one call.
    params: the stack's 16*N parameters (as for kernel 3); saved: kernel 3's
    [N, B, T, D] layer inputs and dy the gradient of the stack's output
    [B, T, D], float32; seeds [N, 4]; hash4: as kernel 3's.  Returns (dx,
    [16 gradients, each
    stacked over the layers as [N, ...]]) in float32, bit-identical to
    `encoder_layer_bwd` called for every layer."""
    if not use_kernel(saved):
        return encoder_stack_bwd_plain(params, saved, dy, kmask, seeds, p, h,
                                       hash4)
    global stack_bwd_launches
    what = "encoder_stack_bwd"
    dtype_code, n_layers, B, T, D, F, km = _stack_bwd_args(
        params, saved, dy, kmask, seeds, h, what)
    lib = _build.load()
    _check_path(lib.mmtx_encoder_bwd_path, dtype_code, params, D, h, F, what)
    dx = torch.empty_like(dy)
    grads = [torch.empty((n_layers,) + tuple(t.shape), dtype=torch.float32,
                         device=saved.device) for t in params[:N_PARAMS]]
    n = lib.mmtx_encoder_train_workspace(dtype_code, B, T, D, h, F, 2)
    ws = torch.empty(n, dtype=torch.uint8, device=saved.device)
    ptrs = _build.pointer_array([t.data_ptr() for t in params])
    gptrs = _build.pointer_array([g.data_ptr() for g in grads])
    with torch.cuda.device(saved.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mmtx_encoder_stack_bwd(
            dtype_code, saved.data_ptr(), dy.data_ptr(), km.data_ptr(), ptrs,
            n_layers, _seed_array(seeds), keep_threshold(p), 1.0 - p,
            _hash4_t8(hash4, p), dx.data_ptr(), gptrs, ws.data_ptr(), B, T,
            D, h, F, stream)
    _build.check(rc, what)
    stack_bwd_launches += 1
    return dx, grads


class EncoderStackTrain(torch.autograd.Function):
    """Training-path encoder stack without the final norm: forward kernel 3;
    backward kernel 4 once per layer, last layer first ("perlayer"), or
    kernel 5 once ("stack")."""

    @staticmethod
    def forward(ctx, x, kmask, seeds, p, h, backward, hash4, *params):
        out, saved = encoder_stack_train_fwd(params, x, kmask, seeds, p, h,
                                             hash4)
        ctx.save_for_backward(kmask, saved, *params)
        ctx.seeds, ctx.p, ctx.h, ctx.backward = seeds, p, h, backward
        ctx.hash4 = hash4
        return out

    @staticmethod
    def backward(ctx, g):
        kmask, saved, *params = ctx.saved_tensors
        dy = g.to(saved.dtype).contiguous()
        grads = [None] * len(params)
        if ctx.backward == "stack":
            dy, stacked = encoder_stack_bwd(params, saved, dy, kmask,
                                            ctx.seeds, ctx.p, ctx.h,
                                            ctx.hash4)
            for l in range(saved.shape[0]):
                grads[N_PARAMS * l:N_PARAMS * (l + 1)] = [s[l] for s in stacked]
        else:
            for l in reversed(range(saved.shape[0])):
                lp = params[N_PARAMS * l:N_PARAMS * (l + 1)]
                dy, gl = encoder_layer_bwd(lp, saved[l], dy, kmask,
                                           ctx.seeds[l], ctx.p, ctx.h,
                                           ctx.hash4)
                grads[N_PARAMS * l:N_PARAMS * (l + 1)] = gl
        return (dy, None, None, None, None, None, None, *grads)


def encoder_stack_train(enc, x: torch.Tensor, mask: torch.Tensor, *, h: int,
                        p: float, seeds: torch.Tensor,
                        backward: str = "perlayer",
                        hash4: bool = False) -> torch.Tensor:
    """The N training layers of `enc` (no final norm) on x [B, T, D] with key
    mask [B, T, 1] and seeds [N, 4] (of the "hash4" stream with hash4);
    backward: "perlayer" (kernel 4 per layer) or "stack" (kernel 5).
    Returns float32 [B, T, D] (float64 for float64 inputs); differentiable
    in x and every layer parameter."""
    check_encoder_backward(backward)
    params = [t for layer in enc.layers for t in _layer_tensors(layer)]
    kmask = mask[..., 0].to(acc_dtype(x.dtype))
    return EncoderStackTrain.apply(x, kmask, seeds, p, h, backward, hash4,
                                   *params)
