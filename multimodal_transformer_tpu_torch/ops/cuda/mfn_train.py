"""Kernels 6 and 7: the MFN recurrence's training forward and its reverse
recurrence (csrc/mfn_train.cu).

Counterpart of `multimodal_transformer_tpu/ops/pallas/mfn_train.py`
`mfn_states_fused_train` (custom VJP: `_fwd_call`, then `_bwd_call`).
`MFNStatesTrain` is the autograd Function: its forward runs
`mfn_train_fwd` (kernel 6), which returns hs, cs and mems, and its backward
runs `mfn_train_bwd` (kernel 7).  Both wrappers launch the CUDA kernel for a
CUDA tensor and run their plain version for a CPU tensor.

Arguments, batch-major as in ops/cuda/mfn.py:
  xps:   per modality [B, T, 4H_m], the hoisted x @ W_ih^T + b_ih + b_hh;
  whhs:  per modality W_hh [4H_m, H_m];
  gates: the 16 gate-MLP tensors (MFN.gate_tensors order);
  seeds: [T, 2] uint32 values (int64 tensor): the gamma1 and gamma2 hidden
         dropout seeds of each step; the keep bit of hidden unit c of video
         b hashes position b * width + c;
  ps:    (p_gamma1, p_gamma2).

Rounding points, as in the TPU kernels: the recurrence runs in float32
(float64 for float64 inputs) from weights and xp in their storage dtype;
hs, cs and mems are stored in the storage dtype, and the backward
rematerializes each step from those stored t-1 states.  The plain backward
is, step by step from t = T-1 down, `torch.autograd.grad` through the plain
step from the stored states, carrying (dh, dc, dmem).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ..basic import dropout_with_idx, keep_threshold
from ..dispatch import acc_dtype, check_kernel_dtype, use_kernel
from . import _build
from .mfn import MAX_MODS, kernel_args

# Launches since the last reset: kernel 6 and kernel 7 (one per recurrence).
fwd_launches = 0
bwd_launches = 0


def reset_launches() -> None:
    global fwd_launches, bwd_launches
    fwd_launches = bwd_launches = 0


def _gamma_drop(x: torch.Tensor, seed: int, p: float) -> torch.Tensor:
    """Dropout of a [B, width] gamma hidden at positions b * width + c."""
    idx = torch.arange(x.numel(), dtype=torch.int64,
                       device=x.device).view(x.shape)
    return dropout_with_idx(x, seed, p, idx)


def mfn_step(xp_t, h, c, mem, W, G, seed_row, ps):
    """One step of the recurrence in plain PyTorch (differentiable).
    xp_t, h, c: per-modality lists; W: W_hh list; G: the 16 gate tensors;
    seed_row: (gamma1 seed, gamma2 seed).  Returns (h, c, mem) of step t."""
    hid = [w.shape[1] for w in W]
    prev_cs = torch.cat(c, dim=1)
    h_new, c_new = [], []
    for m, H in enumerate(hid):
        z = xp_t[m] + h[m] @ W[m].T
        i = torch.sigmoid(z[:, :H])
        f = torch.sigmoid(z[:, H:2 * H])
        g = torch.tanh(z[:, 2 * H:3 * H])
        o = torch.sigmoid(z[:, 3 * H:])
        c_new.append(f * c[m] + i * g)
        h_new.append(o * torch.tanh(c_new[-1]))
    c_star = torch.cat([prev_cs] + c_new, dim=1)
    att = torch.softmax(F.linear(torch.relu(F.linear(c_star, G[0], G[1])),
                                 G[2], G[3]), dim=1)
    attended = att * c_star
    c_hat = torch.tanh(F.linear(torch.relu(F.linear(attended, G[4], G[5])),
                                G[6], G[7]))
    both = torch.cat([attended, mem], dim=1)

    def gamma(i, seed, p):
        hmid = torch.relu(F.linear(both, G[i], G[i + 1]))
        if p > 0.0:
            hmid = _gamma_drop(hmid, int(seed), p)
        return torch.sigmoid(F.linear(hmid, G[i + 2], G[i + 3]))

    g1 = gamma(8, seed_row[0], ps[0])
    g2 = gamma(12, seed_row[1], ps[1])
    return h_new, c_new, g1 * mem + g2 * c_hat


def _split(x: torch.Tensor, hid) -> list:
    return list(torch.split(x, list(hid), dim=-1))


def mfn_train_fwd_plain(xps, whhs, gates, seeds, ps):
    """(hs [B, T, TH], cs [B, T, TH], mems [B, T, MEM]) in the storage dtype.
    Differentiable: the model's plain path trains through it."""
    dtype = xps[0].dtype
    acc = acc_dtype(dtype)
    B, T = xps[0].shape[:2]
    dev = xps[0].device
    hid = [w.shape[1] for w in whhs]
    mem_dim = gates[6].shape[0]
    W = [w.to(acc) for w in whhs]
    G = [g.to(acc) for g in gates]
    h = [torch.zeros(B, H, dtype=acc, device=dev) for H in hid]
    c = [torch.zeros(B, H, dtype=acc, device=dev) for H in hid]
    mem = torch.zeros(B, mem_dim, dtype=acc, device=dev)
    seeds = torch.as_tensor(seeds).tolist()
    hs, cs, mems = [], [], []
    for t in range(T):
        h, c, mem = mfn_step([x[:, t].to(acc) for x in xps], h, c, mem, W, G,
                             seeds[t], ps)
        hs.append(torch.cat(h, dim=1))
        cs.append(torch.cat(c, dim=1))
        mems.append(mem)
    return tuple(torch.stack(v, dim=1).to(dtype) for v in (hs, cs, mems))


def mfn_train_bwd_plain(xps, whhs, gates, seeds, ps, hs, cs, mems, g_hs,
                        g_mems):
    """(d_xps, d_whhs, d_gates): d_xps in the storage dtype, the parameter
    grads in the accumulation dtype."""
    dtype = xps[0].dtype
    acc = acc_dtype(dtype)
    B, T = xps[0].shape[:2]
    hid = [w.shape[1] for w in whhs]
    seeds = torch.as_tensor(seeds).tolist()
    with torch.enable_grad():
        W = [w.detach().to(acc).requires_grad_() for w in whhs]
        G = [g.detach().to(acc).requires_grad_() for g in gates]
        params = W + G
        d_params = [torch.zeros_like(p) for p in params]
        dh = [torch.zeros(B, H, dtype=acc, device=hs.device) for H in hid]
        dc = [torch.zeros_like(v) for v in dh]
        dmem = torch.zeros(B, mems.shape[-1], dtype=acc, device=hs.device)
        d_xps = [torch.empty_like(x) for x in xps]
        for t in reversed(range(T)):
            if t:
                h = _split(hs[:, t - 1].to(acc), hid)
                c = _split(cs[:, t - 1].to(acc), hid)
                mem = mems[:, t - 1].to(acc)
            else:
                h = [torch.zeros_like(v) for v in dh]
                c = [torch.zeros_like(v) for v in dh]
                mem = torch.zeros_like(dmem)
            h = [v.detach().requires_grad_() for v in h]
            c = [v.detach().requires_grad_() for v in c]
            mem = mem.detach().requires_grad_()
            xp_t = [x[:, t].detach().to(acc).requires_grad_() for x in xps]
            h1, c1, mem1 = mfn_step(xp_t, h, c, mem, W, G, seeds[t], ps)
            gh = _split(g_hs[:, t].to(acc), hid)
            outs = h1 + c1 + [mem1]
            cots = [a + b for a, b in zip(gh, dh)] + dc + [
                g_mems[:, t].to(acc) + dmem]
            grads = torch.autograd.grad(outs, xp_t + h + c + [mem] + params,
                                        cots)
            n = len(hid)
            for m in range(n):
                d_xps[m][:, t] = grads[m].to(dtype)
            dh = list(grads[n:2 * n])
            dc = list(grads[2 * n:3 * n])
            dmem = grads[3 * n]
            for d, g in zip(d_params, grads[3 * n + 1:]):
                d += g
    return d_xps, d_params[:len(hid)], d_params[len(hid):]


def _device_seeds(seeds, T: int, device) -> torch.Tensor:
    s = np.asarray(torch.as_tensor(seeds).cpu(), dtype=np.int64)
    if s.shape != (T, 2):
        raise ValueError(f"MFN seeds must be [{T}, 2], got {s.shape}")
    return torch.from_numpy(s.astype(np.uint32).view(np.int32)).to(device)


def _rates(ps):
    return (keep_threshold(ps[0]), keep_threshold(ps[1]), 1.0 - ps[0],
            1.0 - ps[1])


def mfn_train_fwd(xps, whhs, gates, seeds, ps):
    """Kernel 6.  Returns (hs, cs, mems) in the storage dtype."""
    x0 = xps[0]
    if not use_kernel(x0):
        return mfn_train_fwd_plain(xps, whhs, gates, seeds, ps)
    global fwd_launches
    what = "mfn_train_fwd"
    dtype_code, B, T, mem, h1, h2, hg1, hg2, hid = kernel_args(
        xps, whhs, gates, what)
    total_h = sum(hid)
    hs = torch.empty((B, T, total_h), dtype=x0.dtype, device=x0.device)
    cs = torch.empty_like(hs)
    mems = torch.empty((B, T, mem), dtype=x0.dtype, device=x0.device)
    dseeds = _device_seeds(seeds, T, x0.device)
    xp_ptrs = _build.pointer_array([t.data_ptr() for t in xps])
    whh_ptrs = _build.pointer_array([t.data_ptr() for t in whhs])
    gate_ptrs = _build.pointer_array([t.data_ptr() for t in gates])
    hid_arr = (ctypes.c_int * len(hid))(*hid)
    lib = _build.load()
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mmtx_mfn_train_fwd(
            dtype_code, xp_ptrs, whh_ptrs, hid_arr, len(xps), gate_ptrs,
            dseeds.data_ptr(), *_rates(ps), hs.data_ptr(), cs.data_ptr(),
            mems.data_ptr(), B, T, mem, h1, h2, hg1, hg2, stream)
    _build.check(rc, what)
    fwd_launches += 1
    return hs, cs, mems


def mfn_train_bwd(xps, whhs, gates, seeds, ps, hs, cs, mems, g_hs, g_mems):
    """Kernel 7.  hs, cs, mems: kernel 6's outputs; g_hs, g_mems: their
    cotangents.  Returns (d_xps in the storage dtype, d_whhs, d_gates in
    float32)."""
    x0 = xps[0]
    if not use_kernel(x0):
        return mfn_train_bwd_plain(xps, whhs, gates, seeds, ps, hs, cs, mems,
                                   g_hs, g_mems)
    global bwd_launches
    what = "mfn_train_bwd"
    dtype_code, B, T, mem, h1, h2, hg1, hg2, hid = kernel_args(
        xps, whhs, gates, what)
    total_h = sum(hid)
    for t, shape in ((hs, (B, T, total_h)), (cs, (B, T, total_h)),
                     (mems, (B, T, mem))):
        if (tuple(t.shape) != shape or t.dtype != x0.dtype
                or t.device != x0.device or not t.is_contiguous()):
            raise ValueError(f"{what}: saved states must be contiguous "
                             f"{x0.dtype} on {x0.device} of the forward's shapes")
    g_hs = g_hs.to(device=x0.device, dtype=torch.float32).contiguous()
    g_mems = g_mems.to(device=x0.device, dtype=torch.float32).contiguous()
    if tuple(g_hs.shape) != (B, T, total_h) or tuple(g_mems.shape) != (B, T, mem):
        raise ValueError(f"{what}: cotangents must match hs and mems")
    dseeds = _device_seeds(seeds, T, x0.device)
    d_xps = [torch.empty_like(x) for x in xps]
    d_whhs = [torch.empty(w.shape, dtype=torch.float32, device=x0.device)
              for w in whhs]
    d_gates = [torch.empty(g.shape, dtype=torch.float32, device=x0.device)
               for g in gates]
    hid_arr = (ctypes.c_int * len(hid))(*hid)
    lib = _build.load()
    n_ws = lib.mmtx_mfn_train_workspace(dtype_code, hid_arr, len(hid), B, T,
                                        mem, h1, h2, hg1, hg2)
    if n_ws < 0:
        raise ValueError(f"{what}: shapes refused by the kernel")
    ws = torch.empty(n_ws, dtype=torch.uint8, device=x0.device)
    ptrs = [_build.pointer_array([t.data_ptr() for t in ts])
            for ts in (xps, whhs, gates, d_xps, d_whhs, d_gates)]
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mmtx_mfn_train_bwd(
            dtype_code, ptrs[0], ptrs[1], hid_arr, len(xps), ptrs[2],
            dseeds.data_ptr(), *_rates(ps), hs.data_ptr(), cs.data_ptr(),
            mems.data_ptr(), g_hs.data_ptr(), g_mems.data_ptr(), ptrs[3],
            ptrs[4], ptrs[5], ws.data_ptr(), B, T, mem, h1, h2, hg1, hg2,
            stream)
    _build.check(rc, what)
    bwd_launches += 1
    return d_xps, d_whhs, d_gates


class MFNStatesTrain(torch.autograd.Function):
    """The training recurrence: forward kernel 6, backward kernel 7.
    apply(seeds, ps, n_mods, *xps, *whhs, *gates) -> (hs, mems)."""

    @staticmethod
    def forward(ctx, seeds, ps, n_mods, *tensors):
        xps, whhs = tensors[:n_mods], tensors[n_mods:2 * n_mods]
        gates = tensors[2 * n_mods:]
        hs, cs, mems = mfn_train_fwd(xps, whhs, gates, seeds, ps)
        ctx.save_for_backward(hs, cs, mems, *tensors)
        ctx.seeds, ctx.ps, ctx.n_mods = seeds, ps, n_mods
        return hs, mems

    @staticmethod
    def backward(ctx, g_hs, g_mems):
        hs, cs, mems, *tensors = ctx.saved_tensors
        n = ctx.n_mods
        xps, whhs, gates = tensors[:n], tensors[n:2 * n], tensors[2 * n:]
        d_xps, d_whhs, d_gates = mfn_train_bwd(
            xps, whhs, gates, ctx.seeds, ctx.ps, hs, cs, mems, g_hs, g_mems)
        return (None, None, None, *d_xps, *d_whhs, *d_gates)


def mfn_states_train(xps, whhs, gates, seeds, ps):
    """(hs, mems) of the training recurrence, differentiable in every
    tensor argument."""
    if len(xps) > MAX_MODS:
        raise ValueError(f"mfn_states_train: at most {MAX_MODS} modalities")
    return MFNStatesTrain.apply(seeds, tuple(ps), len(xps), *xps, *whhs,
                                *gates)
