"""Basic building blocks: linear, the windowed CNN embed, the Highway gate
and dropout.

Counterparts of `multimodal_transformer_tpu/ops/basic.py`.  Parameters are in
torch layout, the same as the JAX package's.  Dropout takes a site's seed
in one of the JAX package's two streams: a uint32 seed is its "hash" impl,
a murmur3 fmix32 of (seed, flat position), so the same seed gives the same
mask bits here, in the CUDA kernels and in the JAX package; a threefry key
(utils/prng.py) is its "threefry" impl, `jax.random.bernoulli(key, 1 - p,
shape)`, whose mask kernel T draws on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import prng

_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for int64 a in [0, 2**32): the product is split in
    16-bit halves so that no intermediate leaves the int64 range."""
    lo = (a & 0xFFFF) * c
    hi = ((a >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def keep_threshold(p: float) -> int:
    """The uint32 drop threshold of probability p, computed exactly as the
    JAX package does: P(hash < t) = p."""
    return min(int(round(p * 2.0 ** 32)), 2 ** 32 - 1)


def hash_keep_mask(seed: int, idx: torch.Tensor, p: float) -> torch.Tensor:
    """Bernoulli(1 - p) keep mask: murmur3's fmix32 over the position counter
    idx (int64 holding uint32 values) with the uint32 seed injected up front.
    Bit-identical to the JAX package's `hash_keep_mask`."""
    h = (_mul32(idx & _M32, 0x9E3779B1) + (int(seed) & _M32)) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h >= keep_threshold(p)


def apply_keep(x: torch.Tensor, keep: torch.Tensor, p: float) -> torch.Tensor:
    """Inverted dropout with a given keep mask: where(keep, x / (1 - p), 0)."""
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def dropout_with_idx(x: torch.Tensor, seed: int, p: float,
                     idx: torch.Tensor) -> torch.Tensor:
    """Inverted dropout whose mask bits hash the given positions."""
    if p == 0.0:
        return x
    return apply_keep(x, hash_keep_mask(seed, idx, p), p)


def dropout(x: torch.Tensor, seed, p: float) -> torch.Tensor:
    """Inverted dropout, where(keep, x / (1 - p), 0).  seed: a uint32 hash
    seed (the keep bits of x's flat positions), a threefry key
    (`jax.random.bernoulli(key, 1 - p, x.shape)`), a data-parallel rank's
    `prng.RowKeys` (that draw over the global (rows, *x.shape[1:]) at the
    rank's rows, one range of counters), or None (eval); p == 0 is the
    identity."""
    if seed is None or p == 0.0:
        return x
    if prng.is_keys(seed):
        return apply_keep(x, prng.bernoulli(seed, 1.0 - p, x.shape, x.device),
                          p)
    idx = torch.arange(x.numel(), dtype=torch.int64,
                       device=x.device).view(x.shape)
    return dropout_with_idx(x, seed, p, idx)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor) -> torch.Tensor:
    """y = x @ W.T + b with W [out, in]."""
    return F.linear(x, weight, bias)


def conv1d_window_embed(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor) -> torch.Tensor:
    """Conv1d(D -> E, k=2) over the frames of each window, then a max over
    the conv axis.  x: [..., F, D] with F >= 2; weight [E, D, 2]; returns
    [..., E].

    Computed as one matmul over adjacent-frame pairs, [..., F-1, 2D] @
    [2D, E], like the JAX package: `F.conv1d` would go through cuDNN, which
    runs float32 convolutions in TF32 by default."""
    pairs = torch.cat([x[..., :-1, :], x[..., 1:, :]], dim=-1)
    kernel = torch.cat([weight[:, :, 0], weight[:, :, 1]], dim=-1)  # [E, 2D]
    return F.linear(pairs, kernel, bias).amax(dim=-2)


def highway_fn(x: torch.Tensor, wp, bp, wg, bg,
               relu_proj: bool = False) -> torch.Tensor:
    """g * proj(x) + (1 - g) * x with proj(x) = x Wp^T + bp and
    g = sigmoid(x Wg^T + bg).  relu_proj=True is the B1-LSTM variant (ReLU
    on the projection)."""
    proj = F.linear(x, wp, bp)
    if relu_proj:
        proj = torch.relu(proj)
    gate = torch.sigmoid(F.linear(x, wg, bg))
    return gate * proj + (1.0 - gate) * x


class Highway(nn.Module):
    def __init__(self, size: int):
        super().__init__()
        self.linear_projection = nn.Linear(size, size)
        self.linear_gate = nn.Linear(size, size)

    def forward(self, x: torch.Tensor, relu_proj: bool = False) -> torch.Tensor:
        return highway_fn(x, self.linear_projection.weight,
                          self.linear_projection.bias, self.linear_gate.weight,
                          self.linear_gate.bias, relu_proj)
