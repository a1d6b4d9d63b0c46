"""Memory Fusion Network, eval mode.

Counterpart of `multimodal_transformer_tpu/ops/mfn_core.py`.  The LSTM input
projections of every step are hoisted out of the recurrence as one batched
matmul per modality; the recurrence itself is `mfn_scan_fused`
(ops/cuda/mfn.py), which runs the CUDA kernel for CUDA tensors and a plain
Python loop over T for CPU tensors; the output head runs batched afterwards.

Gate algebra (reference MFT/multiTransformer.py:200-224):
    c*       = [c_{t-1}; c_t]
    a        = softmax(att1(c*))        (softmax over the FEATURE axis)
    attended = a * c*
    c^       = tanh(att2(attended))
    both     = [attended; mem]
    mem'     = sigmoid(g1(both)) * mem + sigmoid(g2(both)) * c^
"""

from __future__ import annotations

import torch
from torch import nn

from ..utils.init import init_linear, init_lstm_cell
from .cuda.mfn import mfn_scan_fused

HIDDEN_DIM = {"linguistic": 88, "emotient": 16, "acoustic": 48, "image": 88}
MEM_DIM = 128
H_ATT1, H_ATT2, H_GAMMA1, H_GAMMA2, H_OUT = 128, 256, 64, 64, 64
DROPOUTS = {"att1": 0.0, "att2": 0.0, "gamma1": 0.2, "gamma2": 0.2, "out": 0.5}

GATE_NAMES = ("att1_fc1", "att1_fc2", "att2_fc1", "att2_fc2",
              "gamma1_fc1", "gamma1_fc2", "gamma2_fc1", "gamma2_fc2")


class MFN(nn.Module):
    """dims: per-modality input width (the per-modality embed dims)."""

    def __init__(self, mods, dims, output_dim: int,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.mods = tuple(mods)
        total_h = sum(HIDDEN_DIM[m] for m in self.mods)
        att_in = 2 * total_h
        gamma_in = att_in + MEM_DIM
        for m in self.mods:
            cell = nn.LSTMCell(dims[m], HIDDEN_DIM[m])
            if gen is not None:
                init_lstm_cell(cell, gen)
            setattr(self, f"lstm_{m}", cell)
        shapes = [("att1_fc1", att_in, H_ATT1), ("att1_fc2", H_ATT1, att_in),
                  ("att2_fc1", att_in, H_ATT2), ("att2_fc2", H_ATT2, MEM_DIM),
                  ("gamma1_fc1", gamma_in, H_GAMMA1),
                  ("gamma1_fc2", H_GAMMA1, MEM_DIM),
                  ("gamma2_fc1", gamma_in, H_GAMMA2),
                  ("gamma2_fc2", H_GAMMA2, MEM_DIM),
                  ("out_fc1", total_h + MEM_DIM, H_OUT),
                  ("out_fc2", H_OUT, output_dim)]
        for name, fan_in, fan_out in shapes:
            lin = nn.Linear(fan_in, fan_out)
            if gen is not None:
                init_linear(lin, gen)
            setattr(self, name, lin)

    def gate_tensors(self) -> list:
        """The 16 gate-MLP tensors in kernel order (weight, bias per layer)."""
        out = []
        for name in GATE_NAMES:
            lin = getattr(self, name)
            out += [lin.weight, lin.bias]
        return out


def hoisted_inputs(mfn: MFN, inputs) -> list:
    """x @ W_ih^T + b_ih + b_hh for every step, per modality: [B, T, 4H]."""
    xps = []
    for m in mfn.mods:
        cell = getattr(mfn, f"lstm_{m}")
        xps.append(inputs[m] @ cell.weight_ih.T + cell.bias_ih + cell.bias_hh)
    return xps


def mfn_states(mfn: MFN, inputs):
    """(hs [B, T, total_h], mems [B, T, MEM_DIM]) of the recurrence."""
    whhs = [getattr(mfn, f"lstm_{m}").weight_hh for m in mfn.mods]
    return mfn_scan_fused(hoisted_inputs(mfn, inputs), whhs,
                          mfn.gate_tensors())


def mfn_head(mfn: MFN, hs: torch.Tensor, mems: torch.Tensor) -> torch.Tensor:
    feats = torch.cat([hs, mems], dim=-1)
    return mfn.out_fc2(torch.relu(mfn.out_fc1(feats)))


def mfn_scan(mfn: MFN, inputs) -> torch.Tensor:
    """MFN forward.  inputs: mod -> [B, T, D_mod].  Returns [B, T, out]."""
    hs, mems = mfn_states(mfn, inputs)
    return mfn_head(mfn, hs, mems)
