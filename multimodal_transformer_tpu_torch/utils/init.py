"""Parameter initialisers matching PyTorch's layer defaults, drawn along
`jax.random`'s key tree.

Counterpart of `multimodal_transformer_tpu/utils/torch_init.py`: each
initialiser takes a threefry key (utils/prng.py) and returns the JAX
package's parameter tree for the layer, with the same numbers for the same
key:

  linear_init:   weight, bias ~ U(-k, k),  k = 1/sqrt(fan_in)
  conv1d_init:   weight, bias ~ U(-k, k),  k = 1/sqrt(in_channels * kernel)
  lstm_init:     all params   ~ U(-k, k),  k = 1/sqrt(hidden_size)
  norm_init:     the quirky norm's a_2 = 1, b_2 = 0

Shapes are torch layouts (Linear weight [out, in], LSTM weight_ih [4H, in]),
the same as the JAX package's, so a tree loads into a module key for key
(`utils/params.py load_jax_params`).  The draws are made on `device`: on
the card by kernel T, on the CPU by its plain version; the bits are the
same.
"""

from __future__ import annotations

import math

import torch

from . import prng


def _uniform(key, shape, bound: float, device):
    return prng.uniform(key, shape, -bound, bound, device)


def linear_init(key, in_dim: int, out_dim: int, device="cpu") -> dict:
    """nn.Linear's default init (weight [out, in])."""
    kw, kb = prng.split(key)
    bound = 1.0 / math.sqrt(in_dim)
    return {"weight": _uniform(kw, (out_dim, in_dim), bound, device),
            "bias": _uniform(kb, (out_dim,), bound, device)}


def conv1d_init(key, in_ch: int, out_ch: int, kernel: int,
                device="cpu") -> dict:
    """nn.Conv1d's default init (weight [out, in, k])."""
    kw, kb = prng.split(key)
    bound = 1.0 / math.sqrt(in_ch * kernel)
    return {"weight": _uniform(kw, (out_ch, in_ch, kernel), bound, device),
            "bias": _uniform(kb, (out_ch,), bound, device)}


def lstm_init(key, in_dim: int, hidden: int, device="cpu") -> dict:
    """nn.LSTMCell's default init, gates along 4H in torch's order
    (i, f, g, o)."""
    k1, k2, k3, k4 = prng.split(key, 4)
    bound = 1.0 / math.sqrt(hidden)
    return {"weight_ih": _uniform(k1, (4 * hidden, in_dim), bound, device),
            "weight_hh": _uniform(k2, (4 * hidden, hidden), bound, device),
            "bias_ih": _uniform(k3, (4 * hidden,), bound, device),
            "bias_hh": _uniform(k4, (4 * hidden,), bound, device)}


def norm_init(features: int, device="cpu") -> dict:
    """The reference's LayerNorm parameters (a_2 = 1, b_2 = 0)."""
    return {"a_2": torch.ones(features, device=device),
            "b_2": torch.zeros(features, device=device)}

