"""Parameter initialisers matching PyTorch's layer defaults.

Counterpart of `multimodal_transformer_tpu/utils/torch_init.py`, drawing from
a `torch.Generator` so that weights can be made on any device from a seed:

  nn.Linear:     weight, bias ~ U(-k, k),  k = 1/sqrt(fan_in)
  nn.Conv1d:     weight, bias ~ U(-k, k),  k = 1/sqrt(in_channels * kernel)
  LSTM(Cell):    all params   ~ U(-k, k),  k = 1/sqrt(hidden_size)
  quirky norm:   a_2 = 1, b_2 = 0

Shapes are torch layouts (Linear weight [out, in], LSTM weight_ih [4H, in]),
the same as the JAX package's, so parameter trees cross over key for key.
The numbers differ from `jax.random`'s for the same seed.
"""

from __future__ import annotations

import math

import torch


def uniform_(t: torch.Tensor, bound: float,
             gen: torch.Generator) -> torch.Tensor:
    """Fill t in place with U(-bound, bound) drawn from gen.

    The draw is made on gen's device and copied, so a CPU generator gives
    the same weights whatever device the module lives on."""
    with torch.no_grad():
        u = torch.rand(t.shape, generator=gen, dtype=torch.float32,
                       device=gen.device)
        t.copy_(u.mul_(2 * bound).sub_(bound))
    return t


def init_linear(lin: torch.nn.Linear, gen: torch.Generator) -> None:
    bound = 1.0 / math.sqrt(lin.in_features)
    uniform_(lin.weight, bound, gen)
    uniform_(lin.bias, bound, gen)


def init_conv1d(conv: torch.nn.Conv1d, gen: torch.Generator) -> None:
    bound = 1.0 / math.sqrt(conv.in_channels * conv.kernel_size[0])
    uniform_(conv.weight, bound, gen)
    uniform_(conv.bias, bound, gen)


def init_lstm(cell: torch.nn.LSTMCell, gen: torch.Generator) -> None:
    """weight_ih, weight_hh, bias_ih, bias_hh ~ U(-k, k), k = 1/sqrt(H): the
    default of nn.LSTMCell and of a one-layer nn.LSTM (`lstm_init`)."""
    bound = 1.0 / math.sqrt(cell.hidden_size)
    for p in (cell.weight_ih, cell.weight_hh, cell.bias_ih, cell.bias_hh):
        uniform_(p, bound, gen)


def make_linear(fan_in: int, fan_out: int,
                gen: torch.Generator | None = None) -> torch.nn.Linear:
    """nn.Linear(fan_in, fan_out), drawn from gen when it is given."""
    lin = torch.nn.Linear(fan_in, fan_out)
    if gen is not None:
        init_linear(lin, gen)
    return lin


def make_lstm(fan_in: int, hidden: int,
              gen: torch.Generator | None = None) -> torch.nn.LSTMCell:
    """nn.LSTMCell(fan_in, hidden), drawn from gen when it is given."""
    cell = torch.nn.LSTMCell(fan_in, hidden)
    if gen is not None:
        init_lstm(cell, gen)
    return cell
