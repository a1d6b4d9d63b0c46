"""`jax.random`'s threefry key chain and draws, without JAX.

The JAX package draws its weights from `jax.random.PRNGKey(seed)` and each
training step's dropout from `fold_in(PRNGKey(epoch), batch_num)`, split
along each model's key tree.  This module gives the same keys and the same
bits, so that the port starts from the same weights and drops the same
elements as the JAX package for the same seed:

  * `key(seed)`: `PRNGKey(seed)` (jax/_src/prng.py `threefry_seed`): the
    pair (seed >> 32, seed & 0xFFFFFFFF);
  * `split(key, n)`, `fold_in(key, data)`: the "partitionable" threefry
    path (`jax_threefry_partitionable`, on by default in JAX 0.9), where
    split's key i and fold_in(key, i) are both threefry2x32(key, (0, i));
  * `random_bits(key, shape)`: 32-bit bits on that path, bits1 ^ bits2 of
    threefry2x32(key, (hi, lo)) over the flat index's two 32-bit halves;
  * `uniform(key, shape, minval, maxval)`: `jax.random.uniform` in float32,
    ((bits >> 9) | 0x3F800000) viewed as a float, minus 1, then
    f * (maxval - minval) + minval rounded once (XLA contracts it into a
    fused multiply-add), clipped below at minval;
  * `bernoulli(key, p, shape)`: `jax.random.bernoulli`, uniform < p;
  * `hash_seed(key)`: the JAX package's `ops/basic.py hash_seed`, the uint32
    seed of the hash dropout at a site.

Keys are numpy uint32 arrays whose last axis holds the pair; every function
that takes a key also takes a stack of them ([..., 2]) and works on all at
once, the way the JAX package vmaps its splits, so a step's keys are
derived with a few vectorised numpy calls on the host.

`threefry2x32` is written once, on int64 arrays holding uint32 values and
wrapped with `& 0xFFFFFFFF`; it runs on numpy arrays (the keys, on the
host) and on torch tensors (the plain version of kernel T).  The draws
(`random_bits`, `uniform`, `bernoulli`) are made on the given device: on
the card by kernel T (ops/cuda/threefry.py), on the CPU by the plain
version here.  The bits are the same either way.
"""

from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# the CPU draw runs over chunks of the flat index that stay in the cache,
# _CHUNK elements a thread (on the card the plain version takes the whole
# index at once)
_CHUNK = 1 << 16


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (jax/_src/prng.py
    `_threefry2x32_lowering`): int64 numpy arrays or torch tensors of uint32
    values, broadcast together.  Returns the two output words.  The rounds
    update two fresh arrays in place."""
    ks = (k0, k1, (k0 ^ k1 ^ _PARITY) & M32)
    x0 = x0 + ks[0] + x1 * 0  # broadcast both words to the full shape
    x0 &= M32
    x1 = x1 + ks[1] + x0 * 0
    x1 &= M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            x0 &= M32
            low = x1 >> (32 - r)
            x1 <<= r
            x1 |= low
            x1 &= M32
            x1 ^= x0
        x0 += ks[(i + 1) % 3]
        x0 &= M32
        x1 += ks[(i + 2) % 3] + (i + 1)
        x1 &= M32
    return x0, x1


def _words(keys) -> tuple:
    k = np.asarray(keys, dtype=np.uint32).astype(np.int64)
    if k.shape[-1:] != (2,):
        raise ValueError(f"a threefry key has 2 words, got shape {k.shape}")
    return k[..., 0], k[..., 1]


def _keys(y0, y1) -> np.ndarray:
    return np.stack([y0, y1], axis=-1).astype(np.uint32)


def is_keys(value) -> bool:
    """Whether value is a threefry key or a stack of them ([..., 2] numpy
    uint32), as a dropout site or a table of sites holds them under the
    "threefry" dropout (a hash seed is an int or an int64 tensor)."""
    return (isinstance(value, np.ndarray) and value.dtype == np.uint32
            and value.ndim >= 1 and value.shape[-1] == 2)


def key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)` for a seed in [-2**31, 2**32): the pair
    (0, seed mod 2**32), as JAX builds it from a 32-bit seed."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 32:
        raise ValueError(f"seed {seed} is not a 32-bit integer")
    return np.array([0, seed & M32], dtype=np.uint32)


def fold_in(keys, data) -> np.ndarray:
    """`jax.random.fold_in`: threefry2x32(key, (0, data)).  keys [..., 2];
    data an integer or an integer array broadcast against keys[..., 0]."""
    k0, k1 = _words(keys)
    d = np.asarray(data, dtype=np.int64) & M32
    return _keys(*threefry2x32(k0, k1, np.zeros_like(d), d))


def split(keys, n: int = 2) -> np.ndarray:
    """`jax.random.split(key, n)`: key i is threefry2x32(key, (0, i)).
    keys [..., 2] -> [..., n, 2]."""
    k0, k1 = _words(keys)
    i = np.arange(n, dtype=np.int64)
    return _keys(*threefry2x32(k0[..., None], k1[..., None],
                               np.zeros_like(i), i))


def hash_seed(keys) -> np.ndarray:
    """The JAX package's `hash_seed` of each key: keys [..., 2] -> uint32
    [...]; s = 0x2545F491, s = (s ^ k0) * 0x9E3779B1, s = (s ^ k1) *
    0x9E3779B3, mod 2**32."""
    k = np.asarray(keys, dtype=np.uint32).astype(np.uint64)
    seed = np.full(k.shape[:-1], 0x2545F491, dtype=np.uint64)
    for i in range(2):
        seed = ((seed ^ k[..., i]) * np.uint64(0x9E3779B1 + 2 * i)) & M32
    return seed.astype(np.uint32)


# ----------------------------------------------------------- the draws

def random_bits_plain(keys, n: int, device="cpu") -> torch.Tensor:
    """Kernel T's bits in plain PyTorch: for each of the K keys of
    keys [K, 2], the 32-bit bits of n flat positions; int64 [K, n] holding
    uint32 values."""
    k0, k1 = (torch.from_numpy(w).to(device)[:, None] for w in _words(keys))
    out = torch.empty(k0.shape[0], n, dtype=torch.int64, device=device)
    chunk = (_CHUNK * torch.get_num_threads() if out.device.type == "cpu"
             else n)
    for lo in range(0, n, chunk):
        idx = torch.arange(lo, min(lo + chunk, n), dtype=torch.int64,
                           device=device)
        y0, y1 = threefry2x32(k0, k1, idx >> 32, idx & M32)
        out[:, lo:lo + idx.numel()] = y0 ^ y1
    return out


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """`jax.random.uniform`'s float32 in [0, 1) from 32-bit bits (any
    integer dtype holding them): ((bits >> 9) | 0x3F800000) as a float,
    minus 1."""
    mant = ((bits.to(torch.int64) & M32) >> 9) | 0x3F800000
    return mant.to(torch.int32).view(torch.float32) - 1.0


def keep_mask_plain(keys, n: int, p: float, device="cpu") -> torch.Tensor:
    """Kernel T's keep mask in plain PyTorch: uniform < p (p rounded to
    float32 first, as `jax.random.bernoulli` does), bool [K, n]."""
    p32 = torch.tensor(p, dtype=torch.float32, device=device)
    return bits_to_unit(random_bits_plain(keys, n, device)) < p32


def _stack(keys) -> tuple:
    k = np.asarray(keys, dtype=np.uint32)
    return k.reshape(-1, 2), k.shape[:-1]


def random_bits(keys, shape, device="cuda") -> torch.Tensor:
    """32-bit bits of each key of keys [..., 2] over `shape`: a [..., *shape]
    int32 tensor holding the bits (on the card from kernel T)."""
    from ..ops.cuda import threefry
    flat, lead = _stack(keys)
    n = math.prod(shape)
    return threefry.threefry_bits(flat, n, device).view(*lead, *shape)


def uniform(keys, shape, minval: float, maxval: float,
            device="cuda") -> torch.Tensor:
    """`jax.random.uniform(key, shape, float32, minval, maxval)` of each key
    of keys [..., 2]: [..., *shape] float32.  minval and maxval are rounded
    to float32 first.  f * (maxval - minval) + minval is rounded once, as
    XLA's fused multiply-add rounds it: the float64 product of two float32
    values is exact, and so is its sum with minval for the symmetric
    bounds of the initialisers (f - 1/2 times the range)."""
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=device)
    f = bits_to_unit(random_bits(keys, shape, device))
    fused = f.double() * (hi - lo).double() + lo.double()
    return torch.maximum(lo, fused.float())


def bernoulli(keys, p: float, shape, device="cuda") -> torch.Tensor:
    """`jax.random.bernoulli(key, p, shape)` of each key of keys [..., 2]:
    [..., *shape] bool (on the card from kernel T)."""
    from ..ops.cuda import threefry
    flat, lead = _stack(keys)
    n = math.prod(shape)
    return threefry.threefry_keep_mask(flat, n, p, device).view(*lead, *shape)
