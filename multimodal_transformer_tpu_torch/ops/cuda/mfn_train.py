"""Kernels 6 and 7: the MFN recurrence's training forward and its reverse
recurrence (csrc/mfn_train.cu).

Counterpart of `multimodal_transformer_tpu/ops/pallas/mfn_train.py`
`mfn_states_fused_train` (custom VJP: `_fwd_call`, then `_bwd_call`).
`MFNStatesTrain` is the autograd Function: its forward runs
`mfn_train_fwd` (kernel 6), which returns hs, cs and mems, and its backward
runs `mfn_train_bwd` (kernel 7).  Both wrappers launch the CUDA kernel for a
CUDA tensor and run their plain version for a CPU tensor.

Kernel 6 is kernel B's three stages (csrc/mfn.cu, ops/cuda/mfn.py) in
their training instantiations: the LSTM scan also stores every c_t, and the
memory scan drops the gamma hiddens.  `mfn_train_fwd_staged_plain` computes
the same stages in PyTorch, in that order; `mfn_train_fwd_plain` is the
step-by-step recurrence (the model's CPU path).

Kernel 7 is five stages: (S0) every step recomputed at once from the saved
states; (S1) the memory's reverse scan, one block per video with the gamma
MLPs' mem side in shared memory; (S2) the rest of the VJP over all rows;
(S3) the LSTM's reverse scan, one block per (video, modality) with W_hh in
shared memory; (S4) the parameter gradients as products over all rows.
`mfn_train_bwd_staged_plain` computes the same stages in PyTorch, in that
order.

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

from ..basic import apply_keep, dropout_with_idx, keep_threshold
from ..dispatch import acc_dtype, use_kernel
from . import _build
from .mfn import (_RING, MAX_MODS, MAX_ROW_TILES, MAX_THREADS, SMEM_OPT_IN,
                  _kernel_args, _lanes_per_unit, _round_up, _staged_threads,
                  staged_args, staged_plain, staged_workspace)

# Launches since the last reset: kernel 6 and kernel 7 (one per recurrence).
fwd_launches = 0
bwd_launches = 0


def reset_launches() -> None:
    global fwd_launches, bwd_launches
    fwd_launches = bwd_launches = 0


def _gamma_drop(x: torch.Tensor, seed, p: float) -> torch.Tensor:
    """Dropout of a [B, width] gamma hidden at positions b * width + c
    (seed: a hash seed), or with a given [B, width] keep mask."""
    if isinstance(seed, torch.Tensor):
        return apply_keep(x, seed, p)
    idx = torch.arange(x.numel(), dtype=torch.int64,
                       device=x.device).view(x.shape)
    return dropout_with_idx(x, seed, p, idx)


def mfn_step(xp_t, h, c, mem, W, G, seed_row, ps):
    """One step of the recurrence in plain PyTorch (differentiable).
    xp_t, h, c: per-modality lists; W: W_hh list; G: the 16 gate tensors;
    seed_row: (gamma1 seed, gamma2 seed), or the step's two keep masks.
    Returns (h, c, mem) of step t."""
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
            hmid = _gamma_drop(hmid, seed, p)
        return torch.sigmoid(F.linear(hmid, G[i + 2], G[i + 3]))

    g1 = gamma(8, seed_row[0], ps[0])
    g2 = gamma(12, seed_row[1], ps[1])
    return h_new, c_new, g1 * mem + g2 * c_hat


def _split(x: torch.Tensor, hid) -> list:
    return list(torch.split(x, list(hid), dim=-1))


def mfn_train_fwd_plain(xps, whhs, gates, seeds, ps):
    """(hs [B, T, TH], cs [B, T, TH], mems [B, T, MEM]) in the storage dtype.
    Differentiable: the model's plain path trains through it.  seeds may
    also be [T, 2, B, width] bool keep masks (the "threefry" dropout)."""
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
    if not (isinstance(seeds, torch.Tensor) and seeds.dtype == torch.bool):
        seeds = torch.as_tensor(seeds).tolist()
    hs, cs, mems = [], [], []
    for t in range(T):
        h, c, mem = mfn_step([x[:, t].to(acc) for x in xps], h, c, mem, W, G,
                             seeds[t], ps)
        hs.append(torch.cat(h, dim=1))
        cs.append(torch.cat(c, dim=1))
        mems.append(mem)
    return tuple(torch.stack(v, dim=1).to(dtype) for v in (hs, cs, mems))


def mfn_train_fwd_staged_plain(xps, whhs, gates, seeds, ps):
    """Kernel 6's stages in PyTorch, in the kernel's order: kernel B's
    (`ops/cuda/mfn.py:staged_plain`) with the gamma dropout in the memory
    loop.  The same function as `mfn_train_fwd_plain`; gamma fc1's sum is
    split into its attended and mem parts.  Returns (hs, cs, mems) in the
    storage dtype."""
    seeds = torch.as_tensor(seeds).tolist()
    out = staged_plain(xps, whhs, gates,
                       lambda t, k, x: _gamma_drop(x, int(seeds[t][k]), ps[k]))
    return tuple(v.to(xps[0].dtype) for v in out)


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


def _prev(x: torch.Tensor, acc) -> torch.Tensor:
    """x[:, t - 1] at every t, zeros at t = 0, in the accumulation dtype."""
    x = x.to(acc)
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def mfn_train_bwd_staged_plain(xps, whhs, gates, seeds, ps, hs, cs, mems,
                               g_hs, g_mems):
    """Kernel 7's five stages in PyTorch, in the kernel's order: S0 every
    step recomputed from the saved t-1 states at once, S1 the memory's
    reverse scan, S2 the rest of the VJP over all rows, S3 the LSTM's reverse
    scan, S4 the parameter gradients.  The same function as
    `mfn_train_bwd_plain`; only the order of sums differs (gamma fc1's input
    gradient is split into its attended and mem parts, and the two products
    into d attended are one)."""
    dtype = xps[0].dtype
    acc = acc_dtype(dtype)
    B, T = xps[0].shape[:2]
    hid = [w.shape[1] for w in whhs]
    th2 = 2 * sum(hid)
    W = [w.to(acc) for w in whhs]
    G = [g.to(acc) for g in gates]
    seeds = torch.as_tensor(seeds).tolist()
    g_hs, g_mems = g_hs.to(acc), g_mems.to(acc)
    # S0: every row (b, t) from the saved states at t - 1
    h_prev, c_prev, mem_prev = (_prev(v, acc) for v in (hs, cs, mems))
    cells, c_new = [], []
    for xp, w, hp, cp in zip(xps, W, _split(h_prev, hid), _split(c_prev, hid)):
        H = w.shape[1]
        z = xp.to(acc) + hp @ w.T
        ig, fg = torch.sigmoid(z[..., :H]), torch.sigmoid(z[..., H:2 * H])
        gg, og = torch.tanh(z[..., 2 * H:3 * H]), torch.sigmoid(z[..., 3 * H:])
        c_new.append(fg * cp + ig * gg)
        cells.append((ig, fg, gg, og, torch.tanh(c_new[-1]), cp))
    c_star = torch.cat([c_prev] + c_new, dim=-1)
    a_h = torch.relu(F.linear(c_star, G[0], G[1]))
    att = torch.softmax(F.linear(a_h, G[2], G[3]), dim=-1)
    attended = att * c_star
    b_h = torch.relu(F.linear(attended, G[4], G[5]))
    c_hat = torch.tanh(F.linear(b_h, G[6], G[7]))
    both = torch.cat([attended, mem_prev], dim=-1)

    def gamma_hidden(i, which, p):
        hmid = torch.relu(F.linear(both, G[i], G[i + 1]))
        if p > 0.0:
            hmid = torch.stack([_gamma_drop(hmid[:, t], int(seeds[t][which]), p)
                                for t in range(T)], dim=1)
        return hmid

    hid1, hid2 = gamma_hidden(8, 0, ps[0]), gamma_hidden(12, 1, ps[1])
    gam1 = torch.sigmoid(F.linear(hid1, G[10], G[11]))
    gam2 = torch.sigmoid(F.linear(hid2, G[14], G[15]))
    # S1: the memory's cotangent, t from T-1 down
    w_mem = torch.cat([G[8][:, th2:], G[12][:, th2:]], dim=0)
    keep = (1.0 - ps[0], 1.0 - ps[1])
    ds1, ds2, dchat, dp1, dp2 = (torch.empty_like(v) for v in
                                 (gam1, gam2, c_hat, hid1, hid2))
    dmemp = torch.zeros_like(gam1[:, 0])
    dp = torch.zeros(B, w_mem.shape[0], dtype=acc, device=gam1.device)
    for t in reversed(range(T)):
        dm = g_mems[:, t] + (dmemp + dp @ w_mem)
        g1, g2, ch = gam1[:, t], gam2[:, t], c_hat[:, t]
        ds1[:, t] = dm * mem_prev[:, t] * g1 * (1 - g1)
        ds2[:, t] = dm * ch * g2 * (1 - g2)
        dchat[:, t] = dm * g2 * (1 - ch * ch)
        dmemp = dm * g1
        dp1[:, t] = torch.where(hid1[:, t] > 0, ds1[:, t] @ G[10] / keep[0], 0)
        dp2[:, t] = torch.where(hid2[:, t] > 0, ds2[:, t] @ G[14] / keep[1], 0)
        dp = torch.cat([dp1[:, t], dp2[:, t]], dim=-1)
    # S2: the rest of the VJP, every row at once
    dbpre = torch.where(b_h > 0, dchat @ G[6], 0)
    d_attended = torch.cat([dbpre, dp1, dp2], dim=-1) @ torch.cat(
        [G[4], G[8][:, :th2], G[12][:, :th2]], dim=0)
    datt = d_attended * c_star
    dlog = att * (datt - (datt * att).sum(-1, keepdim=True))
    dapre = torch.where(a_h > 0, dlog @ G[2], 0)
    dcs = d_attended * att + dapre @ G[0]
    # S3: the LSTM's cotangents, t from T-1 down, one recurrence a modality
    d_xps, dzs = [], []
    for w, (ig, fg, gg, og, tc, cp), gh, dc_prev, dc_new in zip(
            W, cells, _split(g_hs, hid), _split(dcs[..., :th2 // 2], hid),
            _split(dcs[..., th2 // 2:], hid)):
        H = w.shape[1]
        dz = torch.empty(B, T, 4 * H, dtype=acc, device=gh.device)
        dh_c = torch.zeros(B, H, dtype=acc, device=gh.device)
        dc_c = torch.zeros_like(dh_c)
        for t in reversed(range(T)):
            dh = gh[:, t] + dh_c
            dcf = dc_c + dc_new[:, t]
            d_o = dh * tc[:, t]
            dcf = dcf + dh * og[:, t] * (1 - tc[:, t] * tc[:, t])
            dc_c = dcf * fg[:, t] + dc_prev[:, t]
            i_, f_, g_, o_ = ig[:, t], fg[:, t], gg[:, t], og[:, t]
            dz[:, t] = torch.cat([dcf * g_ * i_ * (1 - i_),
                                  dcf * cp[:, t] * f_ * (1 - f_),
                                  dcf * i_ * (1 - g_ * g_),
                                  d_o * o_ * (1 - o_)], dim=-1)
            dh_c = dz[:, t] @ w
        d_xps.append(dz.to(dtype))
        dzs.append(dz)
    # S4: the parameter gradients over every row

    def grad(g, x):
        return (torch.einsum("btn,btk->nk", g, x), g.sum(dim=(0, 1)))

    d_whhs = [torch.einsum("btn,btk->nk", dz, hp)
              for dz, hp in zip(dzs, _split(h_prev, hid))]
    d_gates = []
    for g, x in ((dapre, c_star), (dlog, a_h), (dbpre, attended),
                 (dchat, b_h), (dp1, both), (ds1, hid1), (dp2, both),
                 (ds2, hid2)):
        d_gates.extend(grad(g, x))
    return d_xps, d_whhs, d_gates


def _seed_table(seeds, T: int) -> torch.Tensor:
    """The [T, 2] uint32 seeds as int32 bits in a host tensor."""
    s = np.asarray(torch.as_tensor(seeds).cpu(), dtype=np.int64)
    if s.shape != (T, 2):
        raise ValueError(f"MFN seeds must be [{T}, 2], got {s.shape}")
    return torch.from_numpy(s.astype(np.uint32).view(np.int32))


def _device_seeds(seeds, T: int, device) -> torch.Tensor:
    """The seed table on the card, from pinned memory without a stream sync:
    the host goes on enqueueing while the card works."""
    return _seed_table(seeds, T).pin_memory().to(device, non_blocking=True)


def _rates(ps):
    return (keep_threshold(ps[0]), keep_threshold(ps[1]), 1.0 - ps[0],
            1.0 - ps[1])


# slots of the two scans' per-step records (csrc/mfn_train.cu LSlot, MSlot)
_L_SLOTS, _M_SLOTS = 9, 5


def bwd_smem_bytes(hid, mem: int, hg1: int, hg2: int, itemsize: int) -> dict:
    """Shared memory of a block of kernel 7's two scans, weights in a
    storage dtype of `itemsize` bytes (mirrors csrc/mfn_train.cu
    LstmBwdLayout and MemBwdLayout): "lstm", W_hh of the widest modality
    transposed and padded to a multiple of 4 rows per lane, dz twice and 8
    steps of records; "memory", the mem columns of both gamma fc1 layers and
    both gamma fc2 layers, transposed, dp, ds twice and 8 steps of records.
    Both scans take kernel B's thread counts."""
    th = _staged_threads(hid, mem, hg1, hg2)
    lstm = 0
    for H in hid:
        g4p = _round_up(4 * H, 4 * _lanes_per_unit(H, th["lstm"]))
        lstm = max(lstm, g4p * H * itemsize + 8 * g4p
                   + 4 * _RING * _L_SLOTS * H)
    R = hg1 + hg2
    rp, memp = _round_up(R, 8), _round_up(mem, 8)
    memory = ((mem * rp + R * memp) * itemsize + 4 * rp + 8 * memp
              + 4 * _RING * (_M_SLOTS * mem + R))
    return {"lstm": lstm, "memory": memory}


def check_bwd_fit(hid, mem: int, hg1: int, hg2: int, itemsize: int, B: int,
                  T: int, what: str) -> None:
    """Raises, with the widths, for shapes kernel 7's stages cannot take: a
    scan's block past SMEM_OPT_IN bytes or MAX_THREADS threads, or more rows
    than the batched GEMMs' grid holds."""
    need = bwd_smem_bytes(hid, mem, hg1, hg2, itemsize)
    threads = _staged_threads(hid, mem, hg1, hg2)
    bad = []
    if need["lstm"] > SMEM_OPT_IN or threads["lstm"] > MAX_THREADS:
        bad.append(f"the LSTM reverse scan needs {need['lstm']} bytes and "
                   f"{threads['lstm']} threads for hidden widths {list(hid)}")
    if need["memory"] > SMEM_OPT_IN or threads["memory"] > MAX_THREADS:
        bad.append(f"the memory reverse scan needs {need['memory']} bytes "
                   f"and {threads['memory']} threads for mem={mem}, gamma "
                   f"hiddens {hg1}, {hg2}")
    if _round_up(B * T, 64) // 64 > MAX_ROW_TILES:
        bad.append(f"B={B}, T={T} gives more than {MAX_ROW_TILES} tiles of "
                   "64 rows")
    if bad:
        raise ValueError(f"{what}: {'; '.join(bad)} (a block takes at most "
                         f"{SMEM_OPT_IN} bytes of shared memory and "
                         f"{MAX_THREADS} threads)")


def mfn_train_fwd(xps, whhs, gates, seeds, ps):
    """Kernel 6.  Returns (hs, cs, mems) in the storage dtype.  Raises, with
    the widths, for shapes its stages cannot take."""
    x0 = xps[0]
    if not use_kernel(x0):
        return mfn_train_fwd_plain(xps, whhs, gates, seeds, ps)
    global fwd_launches
    what = "mfn_train_fwd"
    args = staged_args(xps, whhs, gates, what)
    dtype_code, B, T, mem, h1, h2, hg1, hg2, hid = args
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
    ws = staged_workspace(lib, args, x0.device, what)
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mmtx_mfn_train_fwd(
            dtype_code, xp_ptrs, whh_ptrs, hid_arr, len(xps), gate_ptrs,
            dseeds.data_ptr(), *_rates(ps), hs.data_ptr(), cs.data_ptr(),
            mems.data_ptr(), ws.data_ptr(), B, T, mem, h1, h2, hg1, hg2,
            stream)
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
    dtype_code, B, T, mem, h1, h2, hg1, hg2, hid = _kernel_args(
        xps, whhs, gates, what)
    check_bwd_fit(hid, mem, hg1, hg2, x0.element_size(), B, T, what)
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
