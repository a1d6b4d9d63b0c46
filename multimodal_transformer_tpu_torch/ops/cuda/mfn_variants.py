"""Rows 8 and 9 of the TPU kernel table: kernel B's function on the TPU
kernels' two other weight layouts (csrc/mfn_variants.cu).

Counterparts of `multimodal_transformer_tpu/ops/pallas/mfn_kernel.py`
`mfn_scan_pallas_packed` (packing `pack_mfn_params_blockdiag`) and
`mfn_scan_pallas_aligned` (packing `pack_mfn_params_aligned`).  Both take
kernel B's arguments (ops/cuda/mfn.py: the hoisted xps, the W_hh list and
the 16 gate tensors), pack the weights in torch, and return (hs [B, T,
total_h], mems [B, T, mem]) with float32 state, in eval only.  Each wrapper
launches its CUDA kernel for CUDA tensors and runs its plain version, which
does the packed or padded arithmetic step by step, for CPU tensors.  The
model path keeps kernel B (`ops/mfn_core.py:mfn_states`); these two are
reached through `bench_mfn_kernel.py`, as their JAX counterparts are
through `examples/bench_mfn_kernel.py`.

The JAX packers transpose the weights to [in, out]; the port's keep torch's
[out, in], the row-major layout the kernels read: each packed matrix here
is the transpose of the JAX one.

Packed: 5 products a step.  `whh` is the block-diagonal [4TH, TH] W_hh on
the concatenated hidden state (each modality's 4H_m gate rows over its own
H_m columns); `w1g` [h2 + hg1 + hg2, 2TH + mem] fuses att2_fc1 (zero on the
mem columns), gamma1_fc1 and gamma2_fc1 on [attended; mem]; `w2bd` [3 mem,
h2 + hg1 + hg2] holds their second layers block-diagonally.

Aligned: each modality's hidden block padded to HP_m, H_m rounded up to a
multiple of `hp` (the port's ALIGN_HP = 32: 48 -> 64, 88 -> 96, 16 -> 32;
hp = 128 gives the TPU kernel's layout).  Per modality W_hh [4 HP_m, HP_m];
the c* = [c_prev; c_new] and [attended; mem] vectors take the padded
layout, so att1_fc1, att2_fc1 and the gamma first layers get zero columns
there, att1_fc2 zero rows, and att1's logits a -1e9 bias on the pad lanes
(the feature softmax gives them exactly 0).  xp's pad lanes are 0, so a pad
lane's gates are i = f = o = 1/2, g = 0, and c = h = 0 stay exact.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..dispatch import acc_dtype, check_no_grad, use_kernel
from . import _build
from .mfn import _SMEM_LIMIT, _check_shapes, kernel_args, smem_bytes

ALIGN_HP = 32   # the aligned kernel's padding: a warp's 32 lanes
NEG_PAD = -1e9  # att1's logit bias on the pad lanes

# Launches since the last reset (one per recurrence).
packed_launches = 0
aligned_launches = 0


def reset_launches() -> None:
    global packed_launches, aligned_launches
    packed_launches = aligned_launches = 0


class PackedMFN(NamedTuple):
    """The packed variant's weights, torch layout [out, in]."""
    whh: torch.Tensor    # [4TH, TH] block-diagonal
    a1w1: torch.Tensor   # [h1, 2TH]
    a1b1: torch.Tensor
    a1w2: torch.Tensor   # [2TH, h1]
    a1b2: torch.Tensor
    w1g: torch.Tensor    # [h2 + hg1 + hg2, 2TH + mem]
    b1g: torch.Tensor
    w2bd: torch.Tensor   # [3 mem, h2 + hg1 + hg2] block-diagonal
    b2g: torch.Tensor


class AlignedMFN(NamedTuple):
    """The aligned variant's weights: per modality W_hh [4 HP_m, HP_m], the
    16 gate tensors of kernel B in the padded layout, and the HP_m."""
    whhs: list
    gates: list
    hps: list


def _mfn_weights(mfn):
    return ([getattr(mfn, f"lstm_{m}").weight_hh for m in mfn.mods],
            mfn.gate_tensors())


def pack_blockdiag(whhs, gates) -> PackedMFN:
    """The packed weights from kernel B's W_hh list and 16 gate tensors."""
    hid = [w.shape[1] for w in whhs]
    TH = sum(hid)
    (a1w1, a1b1, a1w2, a1b2, a2w1, a2b1, a2w2, a2b2,
     g1w1, g1b1, g1w2, g1b2, g2w1, g2b1, g2w2, g2b2) = gates
    like = dict(dtype=whhs[0].dtype, device=whhs[0].device)
    whh = torch.zeros(4 * TH, TH, **like)
    off = 0
    for w, H in zip(whhs, hid):
        whh[4 * off:4 * (off + H), off:off + H] = w
        off += H
    h2, hg1 = a2w1.shape[0], g1w1.shape[0]
    mem = a2w2.shape[0]
    firsts = (a2w1, g1w1, g2w1)
    w1g = torch.zeros(sum(w.shape[0] for w in firsts), g1w1.shape[1], **like)
    w1g[:h2, :2 * TH] = a2w1          # att2 reads attended only
    w1g[h2:h2 + hg1] = g1w1
    w1g[h2 + hg1:] = g2w1
    w2bd = torch.zeros(3 * mem, w1g.shape[0], **like)
    w2bd[:mem, :h2] = a2w2
    w2bd[mem:2 * mem, h2:h2 + hg1] = g1w2
    w2bd[2 * mem:, h2 + hg1:] = g2w2
    return PackedMFN(whh, a1w1.contiguous(), a1b1.contiguous(),
                     a1w2.contiguous(), a1b2.contiguous(), w1g,
                     torch.cat([a2b1, g1b1, g2b1]), w2bd,
                     torch.cat([a2b2, g1b2, g2b2]))


def pack_mfn_params_blockdiag(mfn) -> PackedMFN:
    """The packed weights of an `ops.mfn_core.MFN`."""
    return pack_blockdiag(*_mfn_weights(mfn))


def padded_widths(hid, hp: int) -> list:
    """HP_m: each hidden width rounded up to a multiple of hp."""
    if hp < 1:
        raise ValueError(f"hp must be positive, got {hp}")
    return [-(-H // hp) * hp for H in hid]


def cstar_positions(hid, hps) -> torch.Tensor:
    """The real lanes of the padded [2 * sum(HP_m)] c* layout: c_prev's
    modalities, then c_new's."""
    thp = sum(hps)
    pos, offp = [], 0
    for H, HP in zip(hid, hps):
        pos += [offp + j for j in range(H)]
        offp += HP
    pos = torch.tensor(pos, dtype=torch.int64)
    return torch.cat([pos, pos + thp])


def pack_aligned(whhs, gates, hp: int = ALIGN_HP) -> AlignedMFN:
    """The aligned weights from kernel B's W_hh list and 16 gate tensors."""
    hid = [w.shape[1] for w in whhs]
    hps = padded_widths(hid, hp)
    like = dict(dtype=whhs[0].dtype, device=whhs[0].device)
    thp2 = 2 * sum(hps)
    cpos = cstar_positions(hid, hps).to(whhs[0].device)
    mem = gates[6].shape[0]
    gpos = torch.cat([cpos, thp2 + torch.arange(mem, device=cpos.device)])
    whh_p = []
    for w, H, HP in zip(whhs, hid, hps):
        wp = torch.zeros(4 * HP, HP, **like)
        for g in range(4):
            wp[g * HP:g * HP + H, :H] = w[g * H:(g + 1) * H]
        whh_p.append(wp)

    def cols(w, pos, n):  # scatter w's columns into a zero [rows, n]
        out = torch.zeros(w.shape[0], n, **like)
        out[:, pos] = w
        return out

    a1w2 = torch.zeros(thp2, gates[2].shape[1], **like)
    a1w2[cpos] = gates[2]
    a1b2 = torch.full((thp2,), NEG_PAD, **like)
    a1b2[cpos] = gates[3]
    padded = list(gates)
    padded[0] = cols(gates[0], cpos, thp2)
    padded[2], padded[3] = a1w2, a1b2
    padded[4] = cols(gates[4], cpos, thp2)
    padded[8] = cols(gates[8], gpos, thp2 + mem)
    padded[12] = cols(gates[12], gpos, thp2 + mem)
    return AlignedMFN(whh_p, [t.contiguous() for t in padded], hps)


def pack_mfn_params_aligned(mfn, hp: int = ALIGN_HP) -> AlignedMFN:
    """The aligned weights of an `ops.mfn_core.MFN`."""
    return pack_aligned(*_mfn_weights(mfn), hp)


def _gates(z: torch.Tensor, H: int):
    """LSTM gates i, f, g, o of a [B, 4H] pre-activation."""
    return (torch.sigmoid(z[:, :H]), torch.sigmoid(z[:, H:2 * H]),
            torch.tanh(z[:, 2 * H:3 * H]), torch.sigmoid(z[:, 3 * H:]))


def mfn_scan_packed_plain(xps, whhs, gates):
    """The packed variant's arithmetic in plain PyTorch: the 5 products of a
    step on the packed weights (float32, float64 for float64 inputs)."""
    dtype = xps[0].dtype
    acc = acc_dtype(dtype)
    B, T = xps[0].shape[:2]
    hid = [w.shape[1] for w in whhs]
    P = PackedMFN(*(t.to(acc) for t in pack_blockdiag(whhs, gates)))
    mem_dim = P.w2bd.shape[0] // 3
    xp = torch.cat(xps, dim=-1)
    h = torch.zeros(B, sum(hid), dtype=acc, device=xp.device)
    c = torch.zeros_like(h)
    mem = torch.zeros(B, mem_dim, dtype=acc, device=xp.device)
    hs_out, mem_out = [], []
    for t in range(T):
        z = xp[:, t].to(acc) + h @ P.whh.T
        hs, cs, off = [], [], 0
        for H in hid:
            i, f, g, o = _gates(z[:, 4 * off:4 * (off + H)], H)
            cs.append(f * c[:, off:off + H] + i * g)
            hs.append(o * torch.tanh(cs[-1]))
            off += H
        c_star = torch.cat([c] + cs, dim=1)
        h, c = torch.cat(hs, dim=1), torch.cat(cs, dim=1)
        att = torch.softmax(F.linear(torch.relu(F.linear(c_star, P.a1w1,
                                                         P.a1b1)),
                                     P.a1w2, P.a1b2), dim=1)
        both = torch.cat([att * c_star, mem], dim=1)
        out = F.linear(torch.relu(F.linear(both, P.w1g, P.b1g)), P.w2bd,
                       P.b2g)
        c_hat = torch.tanh(out[:, :mem_dim])
        g1 = torch.sigmoid(out[:, mem_dim:2 * mem_dim])
        g2 = torch.sigmoid(out[:, 2 * mem_dim:])
        mem = g1 * mem + g2 * c_hat
        hs_out.append(h)
        mem_out.append(mem)
    return (torch.stack(hs_out, dim=1).to(dtype),
            torch.stack(mem_out, dim=1).to(dtype))


def pad_xp(xp: torch.Tensor, H: int, HP: int) -> torch.Tensor:
    """[B, T, 4H] -> [B, T, 4HP]: each gate block's pad lanes are 0."""
    B, T = xp.shape[:2]
    return F.pad(xp.reshape(B, T, 4, H), (0, HP - H)).reshape(B, T, 4 * HP)


def aligned_step(xp_t, h, c, mem, P: AlignedMFN):
    """One step of the aligned recurrence on padded states.  xp_t, h, c:
    per-modality lists ([B, 4 HP_m], [B, HP_m]); returns (h, c, mem, att),
    att [B, 2 sum(HP_m)] the feature softmax."""
    G = P.gates
    hs, cs = [], []
    for m, HP in enumerate(P.hps):
        i, f, g, o = _gates(xp_t[m] + h[m] @ P.whhs[m].T, HP)
        cs.append(f * c[m] + i * g)
        hs.append(o * torch.tanh(cs[-1]))
    c_star = torch.cat(c + cs, dim=1)

    def mlp(x, k):
        return F.linear(torch.relu(F.linear(x, G[k], G[k + 1])), G[k + 2],
                        G[k + 3])

    att = torch.softmax(mlp(c_star, 0), dim=1)
    attended = att * c_star
    c_hat = torch.tanh(mlp(attended, 4))
    both = torch.cat([attended, mem], dim=1)
    mem = torch.sigmoid(mlp(both, 8)) * mem + torch.sigmoid(mlp(both, 12)) * c_hat
    return hs, cs, mem, att


def mfn_scan_aligned_plain(xps, whhs, gates, hp: int = ALIGN_HP):
    """The aligned variant's arithmetic in plain PyTorch, step by step on
    the padded layout; returns the real lanes (float32, float64 for float64
    inputs)."""
    dtype = xps[0].dtype
    acc = acc_dtype(dtype)
    B, T = xps[0].shape[:2]
    hid = [w.shape[1] for w in whhs]
    P = pack_aligned(whhs, gates, hp)
    P = AlignedMFN([w.to(acc) for w in P.whhs], [g.to(acc) for g in P.gates],
                   P.hps)
    xp = [pad_xp(x, H, HP) for x, H, HP in zip(xps, hid, P.hps)]
    h = [torch.zeros(B, HP, dtype=acc, device=xps[0].device) for HP in P.hps]
    c = [torch.zeros_like(v) for v in h]
    mem = torch.zeros(B, P.gates[6].shape[0], dtype=acc, device=xps[0].device)
    hs_out, mem_out = [], []
    for t in range(T):
        h, c, mem, _ = aligned_step([x[:, t].to(acc) for x in xp], h, c, mem,
                                    P)
        hs_out.append(torch.cat([v[:, :H] for v, H in zip(h, hid)], dim=1))
        mem_out.append(mem)
    return (torch.stack(hs_out, dim=1).to(dtype),
            torch.stack(mem_out, dim=1).to(dtype))


def aligned_smem_bytes(hps, mem: int, h1: int, h2: int, hg1: int,
                       hg2: int) -> int:
    """Shared memory of one aligned kernel block: the one-block-per-video
    scan's layout (csrc/mfn_common.cuh) over the padded lanes plus one int
    per 32-lane chunk (mirrors csrc/mfn_variants.cu)."""
    return smem_bytes(sum(hps), mem, h1, h2, hg1, hg2) + 4 * (sum(hps) // 32)


def mfn_scan_packed(xps, whhs, gates):
    """Row 8: the recurrence on the block-diagonal packing.  Kernel B's
    arguments and outputs (ops/cuda/mfn.py); eval only."""
    _check_shapes(xps, whhs, gates)
    x0 = xps[0]
    if not use_kernel(x0):
        return mfn_scan_packed_plain(xps, whhs, gates)
    global packed_launches
    what = "mfn_scan_packed"
    check_no_grad(what, *xps, *whhs, *gates)
    dtype_code, B, T, mem, h1, h2, hg1, hg2, hid = kernel_args(
        xps, whhs, gates, what)
    P = pack_blockdiag(whhs, gates)
    hs = torch.empty((B, T, sum(hid)), dtype=x0.dtype, device=x0.device)
    mems = torch.empty((B, T, mem), dtype=x0.dtype, device=x0.device)
    xp_ptrs = _build.pointer_array([t.data_ptr() for t in xps])
    w_ptrs = _build.pointer_array([t.data_ptr() for t in P])
    hid_arr = (ctypes.c_int * len(hid))(*hid)
    lib = _build.load()
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mmtx_mfn_scan_packed(dtype_code, xp_ptrs, hid_arr, len(xps),
                                      w_ptrs, hs.data_ptr(), mems.data_ptr(),
                                      B, T, mem, h1, h2, hg1, hg2, stream)
    _build.check(rc, what)
    packed_launches += 1
    return hs, mems


def mfn_scan_aligned(xps, whhs, gates):
    """Row 9: the recurrence on hidden blocks padded to multiples of
    ALIGN_HP.  Kernel B's arguments and outputs (ops/cuda/mfn.py), the real
    lanes only; eval only."""
    _check_shapes(xps, whhs, gates)
    x0 = xps[0]
    if not use_kernel(x0):
        return mfn_scan_aligned_plain(xps, whhs, gates)
    global aligned_launches
    what = "mfn_scan_aligned"
    check_no_grad(what, *xps, *whhs, *gates)
    dtype_code, B, T, mem, h1, h2, hg1, hg2, hid = kernel_args(
        xps, whhs, gates, what)
    P = pack_aligned(whhs, gates)
    if aligned_smem_bytes(P.hps, mem, h1, h2, hg1, hg2) > _SMEM_LIMIT:
        raise ValueError(f"{what}: padded widths {P.hps} need more than 48 KB "
                         "of shared memory per block")
    hs = torch.empty((B, T, sum(hid)), dtype=x0.dtype, device=x0.device)
    mems = torch.empty((B, T, mem), dtype=x0.dtype, device=x0.device)
    ptrs = [_build.pointer_array([t.data_ptr() for t in ts])
            for ts in (xps, P.whhs, P.gates)]
    hid_arr = (ctypes.c_int * len(hid))(*hid)
    hp_arr = (ctypes.c_int * len(hid))(*P.hps)
    lib = _build.load()
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mmtx_mfn_scan_aligned(dtype_code, ptrs[0], ptrs[1], hid_arr,
                                       hp_arr, len(xps), ptrs[2],
                                       hs.data_ptr(), mems.data_ptr(), B, T,
                                       mem, h1, h2, hg1, hg2, stream)
    _build.check(rc, what)
    aligned_launches += 1
    return hs, mems
