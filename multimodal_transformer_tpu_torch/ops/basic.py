"""Basic building blocks: linear, the windowed CNN embed, the Highway gate
and dropout.

Counterparts of `multimodal_transformer_tpu/ops/basic.py`.  Parameters are in
torch layout, the same as the JAX package's.  Dropout takes a site's seed
in one of the JAX package's three streams, and the seed's type names the
stream:
  * a uint32 seed (an int, or an int64 tensor table) is its "hash" impl, a
    murmur3 fmix32 of (seed, flat position), so the same seed gives the
    same mask bits here, in the CUDA kernels and in the JAX package;
  * a `Hash4Seed` is its "hash4" impl (an encoder's table stays int64 and
    its caller names the stream, `site_seed`): one fmix32 gives four keep
    bytes, each held against an 8-bit threshold, laid out in blocks along
    the last axis (`hash4_keep`); a site whose last axis is not a multiple
    of 4 takes the per-element "hash" bits of the seed;
  * a PRNG key (utils/prng.py: threefry [2] or rbg [4] words) is its
    "threefry" impl, `jax.random.bernoulli(key, 1 - p, shape)`, whose mask
    kernel T (threefry keys) or kernel P (rbg keys) draws on the card.
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


def fmix32(seed: int, idx: torch.Tensor) -> torch.Tensor:
    """murmur3's fmix32 over the position counter idx (int64 holding uint32
    values) with the uint32 seed injected up front: int64 uint32 values."""
    h = (_mul32(idx & _M32, 0x9E3779B1) + (int(seed) & _M32)) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def hash_keep_mask(seed: int, idx: torch.Tensor, p: float) -> torch.Tensor:
    """Bernoulli(1 - p) keep mask: fmix32 of the positions idx kept where it
    is at least the threshold.  Bit-identical to the JAX package's
    `hash_keep_mask`."""
    return fmix32(seed, idx) >= keep_threshold(p)


class Hash4Seed(int):
    """A uint32 dropout seed of the "hash4" stream: the same value as the
    "hash" seed of the site's key, its type choosing the multi-bit mask."""

    def __repr__(self) -> str:
        return f"Hash4Seed({int(self)})"


def is_hash4(seed) -> bool:
    return isinstance(seed, Hash4Seed)


def site_seed(v, hash4: bool = False):
    """One site's seed from a table entry (or a seed): a key stays a key,
    any other value becomes an int, a `Hash4Seed` where `hash4` names that
    stream."""
    if prng.is_keys(v):
        return v
    return Hash4Seed(int(v)) if hash4 else int(v)


def hash4_threshold(p: float) -> int:
    """The 8-bit drop threshold of the "hash4" stream: a byte below
    min(round(p * 256), 255) drops (the JAX package's `hash4_threshold`)."""
    return min(int(round(p * 256.0)), 255)


def hash4_keep(seed: int, rows: torch.Tensor, width: int,
               p: float) -> torch.Tensor:
    """The "hash4" keep mask of the given rows of a [.., width] site (width
    % 4 == 0): rows an int64 tensor of row indices, the mask [*rows.shape,
    width].  Column c of block k = c // (width / 4) takes byte k of
    fmix32(row * width / 4 + c % (width / 4)), kept when it is at least
    `hash4_threshold(p)`: the JAX package's `hash4_keep_rows` layout."""
    w4 = width // 4
    idx4 = rows[..., None] * w4 + torch.arange(w4, dtype=torch.int64,
                                               device=rows.device)
    h = fmix32(seed, idx4)
    by = torch.cat([(h >> (8 * k)) & 0xFF for k in range(4)], dim=-1)
    return by >= hash4_threshold(p)


def hash4_keep_rows(seed: int, n_rows: int, width: int, p: float,
                    device="cpu") -> torch.Tensor:
    """The JAX package's `hash4_keep_rows`: the "hash4" keep mask of a
    [n_rows, width] site, bool."""
    return hash4_keep(seed, torch.arange(n_rows, dtype=torch.int64,
                                         device=device), width, p)


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
    """Inverted dropout, where(keep, x / (1 - p), 0), always at the nominal
    p.  seed: a uint32 hash seed (the keep bits of x's flat positions), a
    `Hash4Seed` (the multi-bit mask of x as [numel / w, w] rows, w =
    x.shape[-1], where w % 4 == 0; else the hash bits), a PRNG key
    (`jax.random.bernoulli(key, 1 - p, x.shape)`), a data-parallel rank's
    `prng.RowKeys` (that draw over the global (rows, *x.shape[1:]) at the
    rank's rows, one range of counters), or None (eval); p == 0 is the
    identity."""
    if seed is None or p == 0.0:
        return x
    if prng.is_keys(seed):
        return apply_keep(x, prng.bernoulli(seed, 1.0 - p, x.shape, x.device),
                          p)
    if is_hash4(seed) and x.dim() >= 1 and x.shape[-1] % 4 == 0:
        w = x.shape[-1]
        keep = hash4_keep_rows(seed, x.numel() // w, w, p, x.device)
        return apply_keep(x, keep.view(x.shape), p)
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
