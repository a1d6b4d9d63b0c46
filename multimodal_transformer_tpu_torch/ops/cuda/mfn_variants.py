"""Rows 8 and 9 of the TPU kernel table: kernel B's function on the TPU
kernels' two other weight layouts (csrc/mfn_variants.cu).

Counterparts of `multimodal_transformer_tpu/ops/pallas/mfn_kernel.py`
`mfn_scan_pallas_packed` (packing `pack_mfn_params_blockdiag`) and
`mfn_scan_pallas_aligned` (packing `pack_mfn_params_aligned`).  Both take
kernel B's arguments (ops/cuda/mfn.py: the hoisted xps, the W_hh list and
the 16 gate tensors), pack the weights in torch, and return (hs [B, T,
total_h], mems [B, T, mem]) with float32 state, in eval only.  Each wrapper
launches kernel B's three stages (csrc/mfn.cu) on views of the packed or
padded tensors (`packed_views`, `aligned_views`: a pointer, row stride and,
for W_hh, gate stride per weight, and the c workspace's row) for CUDA
tensors, and runs its plain version, which does the packed or padded
arithmetic step by step, for CPU tensors.  `mfn.staged_views_plain`
computes the stages on the same views in PyTorch (for row 9:
`mfn_scan_aligned_staged_plain`; row 8's are kernel B's).  The model path
keeps kernel B (`ops/mfn_core.py:mfn_states`); these two are reached
through `bench_mfn_kernel.py`, as their JAX counterparts are through
`examples/bench_mfn_kernel.py`.

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
lane's gates are i = f = o = 1/2, g = 0, and c = h = 0 stay exact.  The
kernel runs only the real units of each W_hh and writes 0 to the c row's
pad lanes.

The stages run on the real widths in both layouts (the padded c row only
widens the workspace and stage 2's products), so kernel B's fit check,
`mfn.check_staged_fit`, is theirs.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..dispatch import acc_dtype, check_no_grad, use_kernel
from . import _build
from .mfn import (View, Views, _check_shapes, offsets, staged_args,
                  staged_views_plain, staged_workspace, whh_view)

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
    """The packed weights from kernel B's W_hh list and 16 gate tensors (a
    few whole-tensor ops: the wrapper packs at every call)."""
    (a1w1, a1b1, a1w2, a1b2, a2w1, a2b1, a2w2, a2b2,
     g1w1, g1b1, g1w2, g1b2, g2w1, g2b1, g2w2, g2b2) = gates
    mem = a2w2.shape[0]
    w1g = torch.cat([F.pad(a2w1, (0, mem)), g1w1, g2w1])  # att2: no mem
    return PackedMFN(torch.block_diag(*whhs), a1w1.contiguous(),
                     a1b1.contiguous(), a1w2.contiguous(), a1b2.contiguous(),
                     w1g, torch.cat([a2b1, g1b1, g2b1]),
                     torch.block_diag(a2w2, g1w2, g2w2),
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


@functools.lru_cache(maxsize=32)
def _real_lanes(hid: tuple, hps: tuple, mem: int, device) -> torch.Tensor:
    """The real lanes of the padded [c*; mem] layout on device, made once
    per layout and device (a copy from the host waits for the card's
    queue)."""
    return torch.cat([cstar_positions(hid, hps),
                      2 * sum(hps) + torch.arange(mem)]).to(device)


def pack_aligned(whhs, gates, hp: int = ALIGN_HP) -> AlignedMFN:
    """The aligned weights from kernel B's W_hh list and 16 gate tensors (a
    few whole-tensor ops: the wrapper packs at every call)."""
    hid = [w.shape[1] for w in whhs]
    hps = padded_widths(hid, hp)
    like = dict(dtype=whhs[0].dtype, device=whhs[0].device)
    thp2, mem = 2 * sum(hps), gates[6].shape[0]
    gpos = _real_lanes(tuple(hid), tuple(hps), mem, whhs[0].device)
    cpos = gpos[:-mem]
    whh_p = [F.pad(w.reshape(4, H, H), (0, HP - H, 0, HP - H)).reshape(
        4 * HP, HP) for w, H, HP in zip(whhs, hid, hps)]

    def cols(w, pos, n):  # w's columns at pos of a zero [rows, n]
        return torch.zeros(w.shape[0], n, **like).index_copy_(1, pos, w)

    padded = list(gates)
    for i in (0, 4):
        padded[i] = cols(gates[i], cpos, thp2)
    for i in (8, 12):
        padded[i] = cols(gates[i], gpos, thp2 + mem)
    padded[2] = torch.zeros(thp2, gates[2].shape[1], **like).index_copy_(
        0, cpos, gates[2])
    padded[3] = torch.full((thp2,), NEG_PAD, **like).index_copy_(0, cpos,
                                                                 gates[3])
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


def packed_views(P: PackedMFN, hid, h2: int, hg1: int) -> Views:
    """Row 8's views of the packed tensors: modality m's W_hh is the
    diagonal block of `whh` at row 4 off_m and column off_m (row stride TH,
    gate stride H_m); att2_fc1 and the gamma fc1 layers are `w1g`'s rows 0,
    h2 and h2 + hg1 (att2 over its first 2TH columns), their biases slices
    of `b1g`; the fc2 layers are `w2bd`'s diagonal blocks, their biases
    slices of `b2g`.  The zero blocks are not in any view."""
    th = sum(hid)
    k, h1 = 2 * th, P.a1w1.shape[0]
    mem = P.w2bd.shape[0] // 3
    hg2 = P.w1g.shape[0] - h2 - hg1

    def mat(base, rows, cols, r0=0, c0=0):
        ld = base.shape[1]
        return View(base, (rows, cols), (ld, 1), r0 * ld + c0)

    def vec(base, n, i0=0):
        return View(base, (n,), (1,), i0)

    whh = tuple(whh_view(P.whh, H, 4 * o * th + o, th, H)
                for o, H in zip(offsets(hid), hid))
    gates = (mat(P.a1w1, h1, k), vec(P.a1b1, h1),
             mat(P.a1w2, k, h1), vec(P.a1b2, k),
             mat(P.w1g, h2, k), vec(P.b1g, h2),
             mat(P.w2bd, mem, h2), vec(P.b2g, mem),
             mat(P.w1g, hg1, k + mem, h2), vec(P.b1g, hg1, h2),
             mat(P.w2bd, mem, hg1, mem, h2), vec(P.b2g, mem, mem),
             mat(P.w1g, hg2, k + mem, h2 + hg1), vec(P.b1g, hg2, h2 + hg1),
             mat(P.w2bd, mem, hg2, 2 * mem, h2 + hg1),
             vec(P.b2g, mem, 2 * mem))
    return Views(whh, gates, th, offsets(hid))


def aligned_views(P: AlignedMFN, hid) -> Views:
    """Row 9's views of the padded tensors: each W_hh's H_m real units
    (row stride and gate stride HP_m), the 16 padded gate tensors as they
    are, and c rows of sum(HP_m) lanes with modality m's at its padded
    offset."""
    whh = tuple(whh_view(w, H, 0, HP, HP)
                for w, H, HP in zip(P.whhs, hid, P.hps))
    gates = tuple(View(g, tuple(g.shape), tuple(g.stride())) for g in P.gates)
    return Views(whh, gates, sum(P.hps), offsets(P.hps))


def _packed_views_of(whhs, gates) -> Views:
    return packed_views(pack_blockdiag(whhs, gates),
                        [w.shape[1] for w in whhs], gates[4].shape[0],
                        gates[8].shape[0])


def _aligned_views_of(whhs, gates, hp: int) -> Views:
    return aligned_views(pack_aligned(whhs, gates, hp),
                         [w.shape[1] for w in whhs])


def mfn_scan_aligned_staged_plain(xps, whhs, gates, hp: int = ALIGN_HP):
    """Row 9's three stages in PyTorch, on the aligned views (stage 2 at K
    = 2 sum(HP_m)), in the kernel's order."""
    hs, _, mems = staged_views_plain(xps, _aligned_views_of(whhs, gates, hp))
    return hs.to(xps[0].dtype), mems.to(xps[0].dtype)


def _view_args(views: Views) -> tuple:
    """The C entries' view arguments: W_hh pointers, row strides and gate
    strides; the gate tensors' pointers and row strides (1 for a bias);
    each modality's first c lane; the c row's width."""
    def ints(v):
        return (ctypes.c_int * len(v))(*v)

    return (_build.pointer_array([v.pointer() for v in views.whh]),
            ints([v.stride[1] for v in views.whh]),
            ints([v.stride[0] // v.stride[1] for v in views.whh]),
            _build.pointer_array([v.pointer() for v in views.gates]),
            ints([v.stride[0] if len(v.size) == 2 else 1
                  for v in views.gates]),
            ints(views.c_off), views.c_width)


def _launch(what: str, xps, args, views: Views, fill=None):
    """Launches the C entry mmtx_<what> on the views; fill, where given,
    fills the workspace first."""
    dtype_code, B, T, mem, h1, h2, hg1, hg2, hid = args
    x0 = xps[0]
    lib = _build.load()
    ws = staged_workspace(lib, args, x0.device, what, views.c_width)
    if fill is not None:
        ws.fill_(fill)
    hs = torch.empty((B, T, sum(hid)), dtype=x0.dtype, device=x0.device)
    mems = torch.empty((B, T, mem), dtype=x0.dtype, device=x0.device)
    xp_ptrs = _build.pointer_array([t.data_ptr() for t in xps])
    hid_arr = (ctypes.c_int * len(hid))(*hid)
    view_args = _view_args(views)
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, f"mmtx_{what}")(
            dtype_code, xp_ptrs, hid_arr, len(xps), *view_args, hs.data_ptr(),
            mems.data_ptr(), ws.data_ptr(), B, T, mem, h1, h2, hg1, hg2,
            stream)
    _build.check(rc, what)
    return hs, mems


def mfn_scan_packed(xps, whhs, gates):
    """Row 8: the recurrence on the block-diagonal packing, kernel B's
    stages on `packed_views`.  Kernel B's arguments and outputs
    (ops/cuda/mfn.py); eval only."""
    _check_shapes(xps, whhs, gates)
    if not use_kernel(xps[0]):
        return mfn_scan_packed_plain(xps, whhs, gates)
    global packed_launches
    what = "mfn_scan_packed"
    check_no_grad(what, *xps, *whhs, *gates)
    args = staged_args(xps, whhs, gates, what)
    out = _launch(what, xps, args, _packed_views_of(whhs, gates))
    packed_launches += 1
    return out


def mfn_scan_aligned(xps, whhs, gates, hp: int = ALIGN_HP, fill=None):
    """Row 9: the recurrence on hidden blocks padded to multiples of hp
    (ALIGN_HP; 128 is the TPU kernel's layout), kernel B's stages on
    `aligned_views`.  Kernel B's arguments and outputs (ops/cuda/mfn.py),
    the real lanes only; eval only.  fill, where given, fills the
    workspace before the launch: with NaN, a pad lane the kernel failed to
    write would spoil every output."""
    _check_shapes(xps, whhs, gates)
    if not use_kernel(xps[0]):
        return mfn_scan_aligned_plain(xps, whhs, gates, hp)
    global aligned_launches
    what = "mfn_scan_aligned"
    check_no_grad(what, *xps, *whhs, *gates)
    args = staged_args(xps, whhs, gates, what)
    out = _launch(what, xps, args, _aligned_views_of(whhs, gates, hp), fill)
    aligned_launches += 1
    return out
