"""Kernel B: the MFN recurrence as three stages from one C entry
(csrc/mfn.cu).  Kernel 6 (ops/cuda/mfn_train.py, the training forward)
runs the same stages.

Counterpart of `multimodal_transformer_tpu/ops/pallas/mfn_kernel.py`
`mfn_scan_pallas` (the recurrence; the input projections and the output
head stay outside, as they do around the `pallas_call`).  `mfn_scan_fused`
launches the CUDA stages for CUDA tensors and runs `mfn_scan_fused_plain`
for CPU tensors.  Both keep state and arithmetic in float32 (float64 for
float64 inputs) and return outputs in the inputs' dtype.

The stages: (1) the LSTM scan, one block per (video, modality) with W_hh in
shared memory; (2) everything that depends only on c_{t-1} and c_t, batched
over all B*T rows: att1, the feature softmax, attended, att2 and c^, and the
attended part of both gamma fc1 layers; (3) the memory scan, one block per
video with the mem side of the gamma MLPs in shared memory.
`mfn_scan_staged_plain` computes the same stages in PyTorch, in that order.
The stages read their weights through `Views` (the layout fields of
csrc/mfn_common.cuh mfn::Args): kernels B and 6 pass the natural layout
(`natural_views`), rows 8 and 9 (ops/cuda/mfn_variants.py) views of the TPU
kernels' packed and padded tensors, and `staged_views_plain` reads the same
views in PyTorch.

Arguments:
  xps:   per modality [B, T, 4H_m], the hoisted x @ W_ih^T + b_ih + b_hh;
  whhs:  per modality W_hh [4H_m, H_m] (gates i, f, g, o);
  gates: the 16 gate-MLP tensors (MFN.gate_tensors order): att1 fc1/fc2,
         att2 fc1/fc2, gamma1 fc1/fc2, gamma2 fc1/fc2, weight then bias.
Returns (hs [B, T, total_h], mems [B, T, mem]).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..dispatch import acc_dtype, check_kernel_dtype, check_no_grad, use_kernel
from . import _build

MAX_MODS = 4
# kernel B's serial stages: shared memory a block may opt in to on sm_90,
# threads a block may have (the fp32 LSTM scan's: csrc/mfn.cu
# lstm_max_threads), and row tiles a GEMM grid may have
SMEM_OPT_IN = 232448
MAX_THREADS = 1024
MAX_LSTM_THREADS_FP32 = 512
MAX_ROW_TILES = 65535

# Number of kernel launches (one per recurrence) since the last reset.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def mfn_scan_fused_plain(xps, whhs, gates):
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

    def mlp(x, i):
        return F.linear(torch.relu(F.linear(x, G[i], G[i + 1])),
                        G[i + 2], G[i + 3])

    hs_out, mem_out = [], []
    for t in range(T):
        prev_cs = torch.cat(c, dim=1)
        for m, H in enumerate(hid):
            z = xps[m][:, t].to(acc) + h[m] @ W[m].T
            i = torch.sigmoid(z[:, :H])
            f = torch.sigmoid(z[:, H:2 * H])
            g = torch.tanh(z[:, 2 * H:3 * H])
            o = torch.sigmoid(z[:, 3 * H:])
            c[m] = f * c[m] + i * g
            h[m] = o * torch.tanh(c[m])
        c_star = torch.cat([prev_cs] + c, dim=1)
        attended = torch.softmax(mlp(c_star, 0), dim=1) * c_star
        c_hat = torch.tanh(mlp(attended, 4))
        both = torch.cat([attended, mem], dim=1)
        g1 = torch.sigmoid(mlp(both, 8))
        g2 = torch.sigmoid(mlp(both, 12))
        mem = g1 * mem + g2 * c_hat
        hs_out.append(torch.cat(h, dim=1))
        mem_out.append(mem)
    return (torch.stack(hs_out, dim=1).to(dtype),
            torch.stack(mem_out, dim=1).to(dtype))


class View(NamedTuple):
    """Where a stage reads one weight: `tensor()`, a strided view of base
    at `offset` elements past its first.  A 2-D weight is [rows, columns]
    with unit column stride, its row stride (ld) stride[0]; W_hh is [4
    gates, H, H] with strides (gate stride * ld, ld, 1)."""
    base: torch.Tensor
    size: tuple
    stride: tuple
    offset: int = 0

    def tensor(self) -> torch.Tensor:
        return torch.as_strided(self.base, self.size, self.stride,
                                self.base.storage_offset() + self.offset)

    def pointer(self) -> int:
        return self.base.data_ptr() + self.offset * self.base.element_size()


class Views(NamedTuple):
    """The layout kernel B's stages read: each modality's W_hh view, the 16
    gate tensors' views in `MFN.gate_tensors` order (att1 fc1, att2 fc1 [N,
    2 c_width], the gamma fc1 layers [N, 2 c_width + mem], att1 fc2 [2
    c_width, h1]), the width of a row of the c workspace, and each
    modality's first lane in it (every other lane is 0)."""
    whh: tuple
    gates: tuple
    c_width: int
    c_off: tuple


def whh_view(base: torch.Tensor, H: int, offset: int, ld: int,
             gate: int) -> View:
    """W_hh [4H, H] in base: gate k's unit j at row k * gate + j past
    `offset`, rows ld elements apart."""
    return View(base, (4, H, H), (gate * ld, ld, 1), offset)


def offsets(widths) -> tuple:
    """Each width's start when they are laid end to end."""
    out, off = [], 0
    for w in widths:
        out.append(off)
        off += w
    return tuple(out)


def natural_views(whhs, gates) -> Views:
    """Kernels B and 6's layout: every tensor as it is, a c row of total_h
    lanes."""
    hid = [w.shape[1] for w in whhs]
    return Views(tuple(whh_view(w, H, 0, H, H) for w, H in zip(whhs, hid)),
                 tuple(View(g, tuple(g.shape), tuple(g.stride()))
                       for g in gates),
                 sum(hid), offsets(hid))


def staged_plain(xps, whhs, gates, drop=None):
    """Kernel B's three stages in PyTorch (`staged_views_plain` on the
    natural layout)."""
    return staged_views_plain(xps, natural_views(whhs, gates), drop)


def staged_views_plain(xps, views: Views, drop=None):
    """Kernel B's three stages in PyTorch, in the kernel's order, reading
    the weights through `views` as the kernel does: the LSTM scan over each
    modality's real units; the feed-forward part batched over all B*T rows
    at K = 2 c_width, on c* rows whose pad lanes are 0; the memory scan.
    drop(t, k, x), where given, returns gamma k's hidden x [B, width] of
    step t after its ReLU, dropped (kernel 6).  Returns (hs, cs, mems) in
    the accumulation dtype, cs on the real lanes."""
    acc = acc_dtype(xps[0].dtype)
    B, T = xps[0].shape[:2]
    dev = xps[0].device
    th2 = 2 * views.c_width
    W = [v.tensor().reshape(4 * v.size[1], v.size[1]).to(acc).contiguous()
         for v in views.whh]
    G = [v.tensor().to(acc).contiguous() for v in views.gates]
    # stage 1: one LSTM recurrence per modality
    hs, cs = [], []
    for xp, w in zip(xps, W):
        H = w.shape[1]
        h = torch.zeros(B, H, dtype=acc, device=dev)
        c = torch.zeros(B, H, dtype=acc, device=dev)
        h_t, c_t = [], []
        for t in range(T):
            z = xp[:, t].to(acc) + h @ w.T
            c = (torch.sigmoid(z[:, H:2 * H]) * c
                 + torch.sigmoid(z[:, :H]) * torch.tanh(z[:, 2 * H:3 * H]))
            h = torch.sigmoid(z[:, 3 * H:]) * torch.tanh(c)
            h_t.append(h)
            c_t.append(c)
        hs.append(torch.stack(h_t, dim=1))
        cs.append(torch.stack(c_t, dim=1))
    c_rows = torch.zeros(B, T + 1, views.c_width, dtype=acc, device=dev)
    for c, off in zip(cs, views.c_off):
        c_rows[:, 1:, off:off + c.shape[2]] = c
    # stage 2: every row (b, t) at once
    c_star = torch.cat([c_rows[:, :-1], c_rows[:, 1:]], dim=2).reshape(B * T,
                                                                      th2)
    logits = F.linear(torch.relu(F.linear(c_star, G[0], G[1])), G[2], G[3])
    attended = torch.softmax(logits, dim=1) * c_star
    c_hat = torch.tanh(F.linear(torch.relu(F.linear(attended, G[4], G[5])),
                                G[6], G[7])).view(B, T, -1)
    p1 = F.linear(attended, G[8][:, :th2], G[9]).view(B, T, -1)
    p2 = F.linear(attended, G[12][:, :th2], G[13]).view(B, T, -1)
    # stage 3: the memory recurrence
    w1, w2 = G[8][:, th2:], G[12][:, th2:]
    mem = torch.zeros(B, G[6].shape[0], dtype=acc, device=dev)
    mems = []
    for t in range(T):
        h1 = torch.relu(p1[:, t] + mem @ w1.T)
        h2 = torch.relu(p2[:, t] + mem @ w2.T)
        if drop is not None:
            h1, h2 = drop(t, 0, h1), drop(t, 1, h2)
        g1 = torch.sigmoid(F.linear(h1, G[10], G[11]))
        g2 = torch.sigmoid(F.linear(h2, G[14], G[15]))
        mem = g1 * mem + g2 * c_hat[:, t]
        mems.append(mem)
    return torch.cat(hs, dim=2), torch.cat(cs, dim=2), torch.stack(mems, dim=1)


def mfn_scan_staged_plain(xps, whhs, gates):
    """Kernel B's three stages in PyTorch (`staged_plain`), in the kernel's
    order.  The same function as `mfn_scan_fused_plain`; gamma fc1's sum is
    split into its attended and mem parts."""
    hs, _, mems = staged_plain(xps, whhs, gates)
    return hs.to(xps[0].dtype), mems.to(xps[0].dtype)


def _check_shapes(xps, whhs, gates):
    if not 1 <= len(xps) <= MAX_MODS or len(whhs) != len(xps):
        raise ValueError(f"mfn_scan_fused: 1..{MAX_MODS} modalities, one W_hh "
                         f"each; got {len(xps)} inputs, {len(whhs)} W_hh")
    if len(gates) != 16:
        raise ValueError(f"mfn_scan_fused: 16 gate tensors, got {len(gates)}")
    B, T = xps[0].shape[:2]
    for xp, w in zip(xps, whhs):
        H = w.shape[1]
        if tuple(w.shape) != (4 * H, H) or tuple(xp.shape) != (B, T, 4 * H):
            raise ValueError(f"mfn_scan_fused: W_hh {tuple(w.shape)} and xp "
                             f"{tuple(xp.shape)} do not agree with B={B}, T={T}")
    th2 = 2 * sum(w.shape[1] for w in whhs)
    h1, h2, hg1, hg2 = (gates[i].shape[0] for i in (0, 4, 8, 12))
    mem = gates[6].shape[0]
    want = [(h1, th2), (h1,), (th2, h1), (th2,), (h2, th2), (h2,), (mem, h2),
            (mem,), (hg1, th2 + mem), (hg1,), (mem, hg1), (mem,),
            (hg2, th2 + mem), (hg2,), (mem, hg2), (mem,)]
    for i, (g, s) in enumerate(zip(gates, want)):
        if tuple(g.shape) != s:
            raise ValueError(f"mfn_scan_fused: gate tensor {i} is "
                             f"{tuple(g.shape)}, expected {s}")
    # the kernel reads weight rows two elements at a time
    widths = [w.shape[1] for w in whhs] + [h1, h2, hg1, hg2, mem]
    if any(n % 2 for n in widths):
        raise ValueError(f"mfn_scan_fused: every hidden width must be even, "
                         f"got {widths}")
    return B, T, mem, h1, h2, hg1, hg2


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# steps of xp rows the LSTM scan keeps in flight (csrc/mfn.cu kRing) and
# its cap on lanes per hidden unit (kLstmLanes)
_RING = 8
_LSTM_LANES = 4


def _lanes_per_unit(H: int, threads: int) -> int:
    """Lanes per hidden unit in kernel B's LSTM scan (mirrors csrc/mfn.cu
    lanes_per_unit)."""
    s = 1
    while s < _LSTM_LANES and H * 2 * s <= threads and 8 * s <= H:
        s *= 2
    return s


def _staged_threads(hid, mem: int, hg1: int, hg2: int) -> dict:
    """Threads of a block of kernel B's two serial stages (mirrors
    csrc/mfn.cu lstm_block and mem_threads)."""
    lstm = max(_round_up(H * _lanes_per_unit(H, MAX_THREADS), 32)
               for H in hid)
    return {"lstm": lstm, "memory": _round_up(2 * max(hg1 + hg2, mem), 32)}


def staged_smem_bytes(hid, mem: int, hg1: int, hg2: int,
                      itemsize: int) -> dict:
    """Shared memory of a block of kernel B's two serial stages, weights in
    a storage dtype of `itemsize` bytes (mirrors csrc/mfn.cu LstmLayout and
    MemLayout): "lstm", W_hh of the widest modality padded to a multiple of
    4 columns per lane, h twice and 8 steps of xp rows; "memory", the mem
    columns of both gamma fc1 layers, both gamma fc2 layers, mem, the gamma
    hiddens and the fc2 biases."""
    th = _staged_threads(hid, mem, hg1, hg2)
    lstm = 0
    for H in hid:
        hp = _round_up(H, 4 * _lanes_per_unit(H, th["lstm"]))
        lstm = max(lstm, hp * 4 * H * itemsize + 8 * hp
                   + _RING * 4 * H * itemsize)
    memp, hgp = _round_up(mem, 8), _round_up(max(hg1, hg2), 4)
    memory = ((memp * (hg1 + hg2) + hgp * 2 * mem) * itemsize + 4 * memp
              + 8 * hgp + 4 * _round_up(2 * mem, 4))
    return {"lstm": lstm, "memory": memory}


def check_staged_fit(hid, mem: int, hg1: int, hg2: int, itemsize: int,
                     B: int, T: int, what: str) -> None:
    """Raises, with the widths, for shapes kernel B's stages cannot take: a
    serial stage's block past SMEM_OPT_IN bytes or MAX_THREADS threads
    (MAX_LSTM_THREADS_FP32 for the fp32 LSTM scan), or more rows than the
    batched GEMMs' grid holds."""
    need = staged_smem_bytes(hid, mem, hg1, hg2, itemsize)
    threads = _staged_threads(hid, mem, hg1, hg2)
    lstm_max = MAX_LSTM_THREADS_FP32 if itemsize == 4 else MAX_THREADS
    bad = []
    if need["lstm"] > SMEM_OPT_IN or threads["lstm"] > lstm_max:
        bad.append(f"the LSTM scan needs {need['lstm']} bytes and "
                   f"{threads['lstm']} threads (at most {lstm_max}) for "
                   f"hidden widths {list(hid)}")
    if need["memory"] > SMEM_OPT_IN or threads["memory"] > MAX_THREADS:
        bad.append(f"the memory scan needs {need['memory']} bytes and "
                   f"{threads['memory']} threads for mem={mem}, gamma "
                   f"hiddens {hg1}, {hg2}")
    if _round_up(B * (T + 1) - 1, 64) // 64 > MAX_ROW_TILES:
        bad.append(f"B={B}, T={T} gives more than {MAX_ROW_TILES} tiles of "
                   "64 rows")
    if bad:
        raise ValueError(f"{what}: {'; '.join(bad)} (a block takes at most "
                         f"{SMEM_OPT_IN} bytes of shared memory and "
                         f"{MAX_THREADS} threads)")


def _kernel_args(xps, whhs, gates, what: str):
    """Checks the dtype, shapes, device and layout every MFN kernel takes and
    returns (dtype code, B, T, mem, h_att1, h_att2, h_g1, h_g2, hidden
    sizes); raises for anything else."""
    x0 = xps[0]
    dtype_code = check_kernel_dtype(x0, what)
    B, T, mem, h1, h2, hg1, hg2 = _check_shapes(xps, whhs, gates)
    for t in list(xps) + list(whhs) + list(gates):
        if t.device != x0.device or t.dtype != x0.dtype or not t.is_contiguous():
            raise ValueError(
                f"{what}: every tensor must be contiguous, on {x0.device} "
                f"and in {x0.dtype}; got {t.dtype} on {t.device}")
    hid = [w.shape[1] for w in whhs]
    return dtype_code, B, T, mem, h1, h2, hg1, hg2, hid


def staged_args(xps, whhs, gates, what: str):
    """`_kernel_args` for kernel B's stages (kernels B and 6, rows 8 and 9):
    also raises, with the widths, where a scan cannot take them
    (`check_staged_fit`), and where an xp does not start on a 16-byte
    boundary (the LSTM scan copies xp rows 16 bytes at a time)."""
    args = _kernel_args(xps, whhs, gates, what)
    B, T, mem, _, _, hg1, hg2, hid = args[1:]
    check_staged_fit(hid, mem, hg1, hg2, xps[0].element_size(), B, T, what)
    if any(x.data_ptr() % 16 for x in xps):
        raise ValueError(f"{what}: the kernel copies xp rows 16 bytes at a "
                         "time; every xp must start on a 16-byte boundary")
    return args


def staged_workspace(lib, args, device, what: str,
                     c_width: int | None = None) -> torch.Tensor:
    """The fp32 workspace of kernel B's stages for `staged_args`' args, at
    a c row of c_width lanes (default: total_h, the natural layout's)."""
    dtype_code, B, T, mem, h1, h2, hg1, hg2, hid = args
    hid_arr = (ctypes.c_int * len(hid))(*hid)
    c_width = sum(hid) if c_width is None else c_width
    n_ws = lib.mmtx_mfn_scan_workspace(dtype_code, hid_arr, len(hid), B, T,
                                       mem, h1, h2, hg1, hg2, c_width)
    if n_ws < 0:
        raise ValueError(f"{what}: shapes refused by the kernel")
    return torch.empty(n_ws // 4, dtype=torch.float32, device=device)


def mfn_scan_fused(xps, whhs, gates):
    """The MFN recurrence.  See the module docstring.  The kernel has no
    backward: on the card it raises when autograd would record the call
    (`ops/mfn_core.py:mfn_states` sends such calls to kernels 6 and 7)."""
    x0 = xps[0]
    if not use_kernel(x0):
        return mfn_scan_fused_plain(xps, whhs, gates)
    global launches
    what = "mfn_scan_fused"
    check_no_grad(what, *xps, *whhs, *gates)
    args = staged_args(xps, whhs, gates, what)
    dtype_code, B, T, mem, h1, h2, hg1, hg2, hid = args
    total_h = sum(hid)
    hid_arr = (ctypes.c_int * len(hid))(*hid)
    lib = _build.load()
    ws = staged_workspace(lib, args, x0.device, what)
    hs = torch.empty((B, T, total_h), dtype=x0.dtype, device=x0.device)
    mems = torch.empty((B, T, mem), dtype=x0.dtype, device=x0.device)
    xp_ptrs = _build.pointer_array([t.data_ptr() for t in xps])
    whh_ptrs = _build.pointer_array([t.data_ptr() for t in whhs])
    gate_ptrs = _build.pointer_array([t.data_ptr() for t in gates])
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mmtx_mfn_scan(dtype_code, xp_ptrs, whh_ptrs, hid_arr, len(xps),
                               gate_ptrs, hs.data_ptr(), mems.data_ptr(),
                               ws.data_ptr(), B, T, mem, h1, h2, hg1, hg2,
                               stream)
    _build.check(rc, what)
    launches += 1
    return hs, mems
