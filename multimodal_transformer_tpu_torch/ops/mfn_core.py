"""Memory Fusion Network.

Counterpart of `multimodal_transformer_tpu/ops/mfn_core.py`.  The LSTM input
projections of every step are hoisted out of the recurrence as one batched
matmul per modality; the output head runs batched afterwards.  In eval the
recurrence is `mfn_scan_fused` (ops/cuda/mfn.py, kernel B); on the card, a
call without seeds that needs gradients takes the training kernels at p = 0
instead (kernel B has no backward).  In training it takes the
[T, 2] gamma1/gamma2 dropout seeds: a CUDA tensor goes to the training
kernels (ops/cuda/mfn_train.py, forward and reverse recurrence), a CPU
tensor to the plain recurrence with autograd; the head drops out its hidden
with the `out` seed.  Both CUDA wrappers run a plain Python loop over T for
CPU tensors.  On the "threefry" dropout the seeds are [T, 2, 2] threefry
keys: every step's two [B, 64] keep masks are drawn at once (kernel T on
the card) and fed to the plain recurrence with autograd on any device, as
the JAX package runs that stream through its `lax.scan` and not its
kernels; the head's `out` key draws `bernoulli(key, 0.5, [T, B, 64])`.
On a data-parallel rank the gamma keys are `prng.RowKeys`, each step's
[B, 64] mask the global batch's at the rank's rows (one range of
counters from r0 * 64), and the head draws its rows of the time-major
site as T ranges of counters (`mfn_head`).
`mfn_init` draws the weights along the JAX key tree.

The head's dropout indexes the TIME-major [T, B, 64] hidden, as the JAX
package's head does (it runs time-major): element [b, t, c] of the port's
batch-major hidden takes the keep bit (hash) or the threefry counter of
position (t * B + b) * 64 + c, or on the "hash4" stream the multi-bit
bits of row t * B + b (with B the global batch's rows and b the global
row on a data-parallel rank, `mfn_head`).  The gamma sites draw the
per-element hash bits on both hash streams, as in the JAX package.

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

from ..utils import prng
from ..utils.init import linear_init, lstm_init
from .basic import apply_keep, dropout_with_idx, hash4_keep, is_hash4
from .cuda.mfn import mfn_scan_fused, mfn_scan_fused_plain
from .cuda.mfn_train import mfn_states_train, mfn_train_fwd_plain
from .dispatch import needs_grad, use_kernel

HIDDEN_DIM = {"linguistic": 88, "emotient": 16, "acoustic": 48, "image": 88}
MEM_DIM = 128
H_ATT1, H_ATT2, H_GAMMA1, H_GAMMA2, H_OUT = 128, 256, 64, 64, 64
DROPOUTS = {"att1": 0.0, "att2": 0.0, "gamma1": 0.2, "gamma2": 0.2, "out": 0.5}

GATE_NAMES = ("att1_fc1", "att1_fc2", "att2_fc1", "att2_fc2",
              "gamma1_fc1", "gamma1_fc2", "gamma2_fc1", "gamma2_fc2")


class MFN(nn.Module):
    """dims: per-modality input width (the per-modality embed dims)."""

    def __init__(self, mods, dims, output_dim: int):
        super().__init__()
        self.mods = tuple(mods)
        for m in self.mods:
            setattr(self, f"lstm_{m}", nn.LSTMCell(dims[m], HIDDEN_DIM[m]))
        for name, fan_in, fan_out in _linear_shapes(self.mods, output_dim):
            setattr(self, name, nn.Linear(fan_in, fan_out))

    def gate_tensors(self) -> list:
        """The 16 gate-MLP tensors in kernel order (weight, bias per layer)."""
        out = []
        for name in GATE_NAMES:
            lin = getattr(self, name)
            out += [lin.weight, lin.bias]
        return out


def _linear_shapes(mods, output_dim: int) -> list:
    """(name, fan_in, fan_out) of the gate and head MLPs, in the JAX
    package's `mfn_init` order."""
    total_h = sum(HIDDEN_DIM[m] for m in mods)
    att_in = 2 * total_h
    gamma_in = att_in + MEM_DIM
    return [("att1_fc1", att_in, H_ATT1), ("att1_fc2", H_ATT1, att_in),
            ("att2_fc1", att_in, H_ATT2), ("att2_fc2", H_ATT2, MEM_DIM),
            ("gamma1_fc1", gamma_in, H_GAMMA1),
            ("gamma1_fc2", H_GAMMA1, MEM_DIM),
            ("gamma2_fc1", gamma_in, H_GAMMA2),
            ("gamma2_fc2", H_GAMMA2, MEM_DIM),
            ("out_fc1", total_h + MEM_DIM, H_OUT),
            ("out_fc2", H_OUT, output_dim)]


def mfn_init(key, mods, dims, output_dim: int, device="cpu") -> dict:
    """The JAX package's `mfn_init` tree: split(key, len(mods) + 10), the
    modalities' LSTMs first, then the ten MLP layers."""
    keys = prng.split(key, len(mods) + 10)
    params = {f"lstm_{m}": lstm_init(keys[i], dims[m], HIDDEN_DIM[m], device)
              for i, m in enumerate(mods)}
    for k, (name, fan_in, fan_out) in zip(
            keys[len(mods):], _linear_shapes(mods, output_dim)):
        params[name] = linear_init(k, fan_in, fan_out, device)
    return params


def hoisted_inputs(mfn: MFN, inputs) -> list:
    """x @ W_ih^T + b_ih + b_hh for every step, per modality: [B, T, 4H]."""
    xps = []
    for m in mfn.mods:
        cell = getattr(mfn, f"lstm_{m}")
        xps.append(inputs[m] @ cell.weight_ih.T + cell.bias_ih + cell.bias_hh)
    return xps


def mfn_states(mfn: MFN, inputs, seeds=None, *, plain: bool = False):
    """(hs [B, T, total_h], mems [B, T, MEM_DIM]) of the recurrence; seeds:
    [T, 2] in training ([T, 2, 2] threefry keys on the "threefry"
    dropout), None in eval; plain=True takes the plain PyTorch recurrence
    on any device."""
    xps = hoisted_inputs(mfn, inputs)
    whhs = [getattr(mfn, f"lstm_{m}").weight_hh for m in mfn.mods]
    gates = mfn.gate_tensors()
    on_card = not plain and use_kernel(xps[0])
    if seeds is None:
        if on_card and needs_grad(*xps, *whhs, *gates):
            # differentiable eval: kernels 6 and 7 at p = 0, as the JAX
            # package differentiates its eval kernel (`_fwd_call` at p = 0)
            zeros = torch.zeros(xps[0].shape[1], 2, dtype=torch.int64)
            return mfn_states_train(xps, whhs, gates, zeros, (0.0, 0.0))
        scan = mfn_scan_fused if on_card else mfn_scan_fused_plain
        return scan(xps, whhs, gates)
    ps = (DROPOUTS["gamma1"], DROPOUTS["gamma2"])
    if prng.is_keys(seeds):
        hs, _, mems = mfn_train_fwd_plain(xps, whhs, gates,
                                          gamma_masks(mfn, seeds, xps[0]), ps)
        return hs, mems
    if not on_card:
        hs, _, mems = mfn_train_fwd_plain(xps, whhs, gates, seeds, ps)
        return hs, mems
    return mfn_states_train(xps, whhs, gates, seeds, ps)


def gamma_masks(mfn: MFN, keys, like: torch.Tensor) -> torch.Tensor:
    """The threefry stream's gamma keep masks, [T, 2, B, 64] bool on like's
    device: `bernoulli(keys[t, k], 1 - p_k, [B, 64])` for every step t and
    gamma k, drawn in one call (both rates are 0.2); keys [T, 2, W] may be
    threefry or rbg keys, or a rank's `prng.RowKeys`, whose masks are the
    global batch's at its rows."""
    B, T = like.shape[:2]
    p = DROPOUTS["gamma1"]
    assert DROPOUTS["gamma2"] == p and keys.shape[:2] == (T, 2)
    return prng.bernoulli(keys, 1.0 - p, (B, mfn.gamma1_fc1.out_features),
                          like.device)


def mfn_head(mfn: MFN, hs: torch.Tensor, mems: torch.Tensor,
             out_seed=None, out_rows=None) -> torch.Tensor:
    """out_rows: (r0, rows) when these B rows are rows r0.. of a global
    batch of `rows` rows (a data-parallel rank): row b then takes the keep
    bits of the global hidden's row r0 + b, position
    (t * rows + r0 + b) * 64 + c (a `Hash4Seed`: the multi-bit bits of the
    time-major row t * rows + r0 + b).  out_seed may be a threefry key, whose
    mask is drawn over the time-major [T, B, 64] hidden and transposed: on
    a rank, T segments of B * 64 counters at stride rows * 64 from
    r0 * 64."""
    feats = torch.cat([hs, mems], dim=-1)
    h = torch.relu(mfn.out_fc1(feats))
    B, T, W = h.shape
    r0, rows = out_rows or (0, B)
    if prng.is_keys(out_seed):
        keep = prng.bernoulli(out_seed, 1.0 - DROPOUTS["out"], (T, B, W),
                              h.device, start=r0 * W, seg_len=B * W,
                              seg_stride=rows * W)
        h = apply_keep(h, keep.transpose(0, 1), DROPOUTS["out"])
    elif out_seed is not None:
        ar = lambda n: torch.arange(n, dtype=torch.int64, device=h.device)
        row = ar(T)[None, :] * rows + r0 + ar(B)[:, None]  # [B, T]
        if is_hash4(out_seed):  # the multi-bit counters of those rows
            keep = hash4_keep(out_seed, row, W, DROPOUTS["out"])
            h = apply_keep(h, keep, DROPOUTS["out"])
        else:
            h = dropout_with_idx(h, int(out_seed), DROPOUTS["out"],
                                 row[..., None] * W + ar(W))
    return mfn.out_fc2(h)


def mfn_scan(mfn: MFN, inputs, seeds=None, out_seed=None, *,
             plain: bool = False, out_rows=None) -> torch.Tensor:
    """MFN forward.  inputs: mod -> [B, T, D_mod]; seeds [T, 2] and
    out_seed in training (out_rows: see mfn_head).  Returns [B, T, out]."""
    hs, mems = mfn_states(mfn, inputs, seeds, plain=plain)
    return mfn_head(mfn, hs, mems, out_seed, out_rows)
