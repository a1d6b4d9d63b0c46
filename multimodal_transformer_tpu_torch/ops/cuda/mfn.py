"""Kernel B: the whole MFN recurrence in one launch (csrc/mfn.cu).

Counterpart of `multimodal_transformer_tpu/ops/pallas/mfn_kernel.py`
`mfn_scan_pallas` (the recurrence; the input projections and the output
head stay outside, as they do around the `pallas_call`).  `mfn_scan_fused`
launches the CUDA kernel for CUDA tensors and runs `mfn_scan_fused_plain`
for CPU tensors.  Both keep state and arithmetic in float32 (float64 for
float64 inputs) and return outputs in the inputs' dtype.

Arguments:
  xps:   per modality [B, T, 4H_m], the hoisted x @ W_ih^T + b_ih + b_hh;
  whhs:  per modality W_hh [4H_m, H_m] (gates i, f, g, o);
  gates: the 16 gate-MLP tensors (MFN.gate_tensors order): att1 fc1/fc2,
         att2 fc1/fc2, gamma1 fc1/fc2, gamma2 fc1/fc2, weight then bias.
Returns (hs [B, T, total_h], mems [B, T, mem]).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..dispatch import acc_dtype, check_kernel_dtype, check_no_grad, use_kernel
from . import _build

MAX_MODS = 4
_SMEM_LIMIT = 48 * 1024

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


def smem_bytes(total_h: int, mem: int, h1: int, h2: int, hg1: int,
               hg2: int) -> int:
    """Shared memory of one kernel block (mirrors csrc/mfn.cu smem_floats)."""
    return 4 * (12 * total_h + h1 + mem + h2 + hg1 + hg2 + 3 * mem + 2)


def kernel_args(xps, whhs, gates, what: str):
    """Checks what the MFN kernels take and returns (dtype code, B, T, mem,
    h_att1, h_att2, h_g1, h_g2, hidden sizes); raises for anything else."""
    x0 = xps[0]
    dtype_code = check_kernel_dtype(x0, what)
    B, T, mem, h1, h2, hg1, hg2 = _check_shapes(xps, whhs, gates)
    for t in list(xps) + list(whhs) + list(gates):
        if t.device != x0.device or t.dtype != x0.dtype or not t.is_contiguous():
            raise ValueError(
                f"{what}: every tensor must be contiguous, on {x0.device} "
                f"and in {x0.dtype}; got {t.dtype} on {t.device}")
    hid = [w.shape[1] for w in whhs]
    if smem_bytes(sum(hid), mem, h1, h2, hg1, hg2) > _SMEM_LIMIT:
        raise ValueError(f"{what}: widths need more than 48 KB of shared "
                         "memory per block")
    return dtype_code, B, T, mem, h1, h2, hg1, hg2, hid


def mfn_scan_fused(xps, whhs, gates):
    """The MFN recurrence.  See the module docstring.  The kernel has no
    backward: on the card it raises when autograd would record the call
    (`ops/mfn_core.py:mfn_states` sends such calls to kernels 6 and 7)."""
    x0 = xps[0]
    if not use_kernel(x0):
        return mfn_scan_fused_plain(xps, whhs, gates)
    global launches
    check_no_grad("mfn_scan_fused", *xps, *whhs, *gates)
    dtype_code, B, T, mem, h1, h2, hg1, hg2, hid = kernel_args(
        xps, whhs, gates, "mfn_scan_fused")
    total_h = sum(hid)
    hs = torch.empty((B, T, total_h), dtype=x0.dtype, device=x0.device)
    mems = torch.empty((B, T, mem), dtype=x0.dtype, device=x0.device)
    xp_ptrs = _build.pointer_array([t.data_ptr() for t in xps])
    whh_ptrs = _build.pointer_array([t.data_ptr() for t in whhs])
    gate_ptrs = _build.pointer_array([t.data_ptr() for t in gates])
    hid_arr = (ctypes.c_int * len(hid))(*hid)
    lib = _build.load()
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mmtx_mfn_scan(dtype_code, xp_ptrs, whh_ptrs, hid_arr, len(xps),
                               gate_ptrs, hs.data_ptr(), mems.data_ptr(), B, T,
                               mem, h1, h2, hg1, hg2, stream)
    _build.check(rc, "mfn_scan_fused")
    launches += 1
    return hs, mems
