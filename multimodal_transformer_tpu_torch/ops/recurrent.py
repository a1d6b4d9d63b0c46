"""Recurrent primitives: the torch-exact LSTM step and scan, and the causal
local-attention convolution.

Counterparts of `multimodal_transformer_tpu/ops/recurrent.py`.  The JAX
package has no kernel for these, so they are plain PyTorch here too.  The
LSTM parameters are an `nn.LSTMCell` (or anything with its `weight_ih`
[4H, D], `weight_hh` [4H, H], `bias_ih` and `bias_hh`), gates ordered
i, f, g, o.  The scan hoists the input projection of every step into one
matmul and runs the [B, H] @ [H, 4H] hidden products in a Python loop over
T; cuDNN's `nn.LSTM` is not used, since its float32 path follows
`cudnn.allow_tf32` and the JAX recurrence is its own scan.
"""

from __future__ import annotations

import torch


def lstm_cell_update(z: torch.Tensor, c: torch.Tensor):
    """(h', c') from the gate pre-activations z [B, 4H] (i, f, g, o) and the
    cell c [B, H]."""
    H = c.shape[-1]
    i, f, o = (torch.sigmoid(z[..., k * H:(k + 1) * H]) for k in (0, 1, 3))
    c = f * c + i * torch.tanh(z[..., 2 * H:3 * H])
    return o * torch.tanh(c), c


def lstm_cell_step(cell, x, h, c):
    """One LSTMCell step.  x [B, D]; h, c [B, H].  Returns (h', c')."""
    z = (x @ cell.weight_ih.T + cell.bias_ih
         + h @ cell.weight_hh.T + cell.bias_hh)
    return lstm_cell_update(z, c)


def lstm_scan(cell, xs, h0=None, c0=None):
    """A one-layer batch-first LSTM over xs [B, T, D].  Returns (hs [B, T, H],
    (h_T, c_T)); h0, c0 default to zeros."""
    B, T, _ = xs.shape
    hidden = cell.weight_hh.shape[1]
    zeros = torch.zeros(B, hidden, dtype=xs.dtype, device=xs.device)
    h = zeros if h0 is None else h0
    c = zeros if c0 is None else c0
    x_proj = xs @ cell.weight_ih.T + cell.bias_ih + cell.bias_hh  # [B, T, 4H]
    w_hh_t = cell.weight_hh.T
    hs = []
    for t in range(T):
        h, c = lstm_cell_update(x_proj[:, t] + h @ w_hh_t, c)
        hs.append(h)
    return torch.stack(hs, dim=1), (h, c)


def pad_shift(x: torch.Tensor, shift: int, padv: float = 0.0) -> torch.Tensor:
    """x [B, T, D] shifted forward in time by `shift` steps (backward for a
    negative shift), padded with padv; |shift| >= T gives all padding."""
    T = x.shape[1]
    if abs(shift) >= T:
        return torch.full_like(x, padv)
    if shift == 0:
        return x
    pad = torch.full((x.shape[0], abs(shift), x.shape[2]), padv,
                     dtype=x.dtype, device=x.device)
    if shift > 0:
        return torch.cat([pad, x[:, :-shift]], dim=1)
    return torch.cat([x[:, -shift:], pad], dim=1)


def convolve_local_attn(x: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """Causal local-attention convolution: out[t] = sum_i attn[t, i] x[t - i].
    x [B, T, D]; attn [B, T, K]."""
    K = attn.shape[2]
    stacked = torch.stack([pad_shift(x, i) for i in range(K)], dim=-1)
    return (attn[:, :, None, :] * stacked).sum(dim=-1)
