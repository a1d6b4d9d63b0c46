"""`jax.random`'s threefry and rbg key chains and draws, without JAX.

The JAX package draws its weights from `jax.random.PRNGKey(seed)` and each
training step's dropout from `fold_in(PRNGKey(epoch), batch_num)`, split
along each model's key tree.  This module gives the same keys and the same
bits, so that the port starts from the same weights and drops the same
elements as the JAX package for the same seed, under either of JAX's key
implementations: "threefry" (the default; keys of 2 words) and "rbg"
(`jax_default_prng_impl="rbg"`, the JAX CLI's `--fast_rng`; keys of 4
words, jax/_src/prng.py `rbg_prng_impl`).  Threefry:

  * `key(seed)`: `PRNGKey(seed)` (jax/_src/prng.py `threefry_seed`): the
    pair (seed >> 32, seed & 0xFFFFFFFF);
  * `split(key, n)`, `fold_in(key, data)`: the "partitionable" threefry
    path (`jax_threefry_partitionable`, on by default in JAX 0.9), where
    split's key i and fold_in(key, i) are both threefry2x32(key, (0, i));
  * `random_bits(key, shape)`: 32-bit bits on that path, bits1 ^ bits2 of
    threefry2x32(key, (hi, lo)) over the flat index's two 32-bit halves;
    the bits at a flat index depend only on the key and the index, so a
    part of a draw is a draw of its counters (`counters`: a start and
    segments), and `RowKeys` draws a data-parallel rank's rows of a
    global draw;
  * `uniform(key, shape, minval, maxval)`: `jax.random.uniform` in float32,
    ((bits >> 9) | 0x3F800000) viewed as a float, minus 1, then
    f * (maxval - minval) + minval rounded once (XLA contracts it into a
    fused multiply-add), clipped below at minval;
  * `bernoulli(key, p, shape)`: `jax.random.bernoulli`, uniform < p;
  * `hash_seed(key)`: the JAX package's `ops/basic.py hash_seed`, the uint32
    seed of the hash dropout at a site (over every word of the key).

Rbg (`key(seed, "rbg")`):

  * `key(seed)` is the threefry key twice, [k0, k1, k0, k1]; `split` and
    `fold_in` apply the threefry ones to each half (`_rbg_split`,
    `_rbg_fold_in`);
  * the bits are `lax.rng_bit_generator(key, shape)` (`_rbg_random_bits`),
    whose default algorithm is XLA's Philox4x32-10 (`philox_bits_plain`):
    the u32[4] key is the u64 pair (s0, s1) = (k0 | k1 << 32, k2 | k3 <<
    32); Philox's key is (k0, k1), and counter i (of ceil(n / 4)) is the
    128-bit value with low half s1 + i and high half s0 plus that sum's
    carry, as the words (lo(s1 + i), hi(s1 + i), lo(hi half), hi(hi
    half)); the four output words of counter i are elements 4i..4i+3 of
    the flat draw, the last counter's tail dropped when n % 4 != 0 (read
    from XLA's expansion of RngBitGenerator on the CPU, and held to
    `jax.random.bits` by tests/test_torch_rbg.py);
  * `uniform` and `bernoulli` take those bits as threefry's do.

Keys are numpy uint32 arrays whose last axis holds the words (2 or 4: the
width names the implementation); every function that takes a key also
takes a stack of them ([..., W]) and works on all at once, the way the JAX
package vmaps its splits, so a step's keys are derived with a few
vectorised numpy calls on the host.

`threefry2x32` is written once, on int64 arrays holding uint32 values and
wrapped with `& 0xFFFFFFFF`; it runs on numpy arrays (the keys, on the
host) and on torch tensors (the plain version of kernel T), as is
`philox4x32` (kernel P's plain version).  The draws (`random_bits`,
`uniform`, `bernoulli`) are made on the given device: on the card by
kernel T (ops/cuda/threefry.py) for threefry keys and kernel P
(ops/cuda/philox.py) for rbg keys, on the CPU by the plain versions here.
The bits are the same either way.
"""

from __future__ import annotations

import dataclasses
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


KEY_WIDTHS = {"threefry": 2, "rbg": 4}
IMPLS = tuple(KEY_WIDTHS)


def _words(keys, width: int = 2) -> tuple:
    """The key words as int64 arrays [...]: `width` of them."""
    k = np.asarray(keys, dtype=np.uint32).astype(np.int64)
    if k.shape[-1:] != (width,):
        raise ValueError(f"a key of {width} words, got shape {k.shape}")
    return tuple(k[..., i] for i in range(width))


def _keys(y0, y1) -> np.ndarray:
    return np.stack([y0, y1], axis=-1).astype(np.uint32)


def impl_of(keys) -> str:
    """The implementation of keys [..., W]: "threefry" (W = 2) or "rbg"
    (W = 4)."""
    w = np.shape(keys.keys if isinstance(keys, RowKeys) else keys)[-1:]
    for name, width in KEY_WIDTHS.items():
        if w == (width,):
            return name
    raise ValueError(f"a key has 2 (threefry) or 4 (rbg) words, got shape "
                     f"{np.shape(keys)}")


def _per_half(fn, keys) -> np.ndarray:
    """A threefry op on each key [..., 2], or on both halves of each rbg
    key [..., 4] (the halves' results joined on the last axis)."""
    k = np.asarray(keys, dtype=np.uint32)
    if impl_of(k) == "threefry":
        return fn(k)
    return np.concatenate([fn(k[..., :2]), fn(k[..., 2:])], axis=-1)


@dataclasses.dataclass(frozen=True, eq=False)
class RowKeys:
    """Keys [..., W] of a data-parallel rank that runs rows
    [r0, r0 + local) of a padded global batch of `rows` rows.  A draw of
    `shape` under them (`random_bits`, `uniform`, `bernoulli`) is the draw
    of the global (rows, *shape[1:]) at the rank's rows: one segment of
    counters from r0 * prod(shape[1:]), as `jax.random.bernoulli` over a
    batch-major site sharded on its rows gives each shard.  Indexing and
    iteration give a table's keys with the same rows."""
    keys: np.ndarray
    r0: int
    rows: int

    def __getitem__(self, i) -> "RowKeys":
        return RowKeys(self.keys[i], self.r0, self.rows)

    def __iter__(self):
        return (self[i] for i in range(len(self.keys)))

    @property
    def shape(self) -> tuple:
        return self.keys.shape


def is_keys(value) -> bool:
    """Whether value is a key or a stack of them ([..., 2] threefry or
    [..., 4] rbg numpy uint32, or RowKeys of them), as a dropout site or a
    table of sites holds them under the "threefry" dropout (a hash seed is
    an int or an int64 tensor)."""
    if isinstance(value, RowKeys):
        value = value.keys
    return (isinstance(value, np.ndarray) and value.dtype == np.uint32
            and value.ndim >= 1 and value.shape[-1] in (2, 4))


def key(seed: int, impl: str = "threefry") -> np.ndarray:
    """`jax.random.PRNGKey(seed)` for a seed in [-2**31, 2**32) under
    `impl`: threefry's pair (0, seed mod 2**32), as JAX builds it from a
    32-bit seed; rbg's [0, s, 0, s], that pair twice."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 32:
        raise ValueError(f"seed {seed} is not a 32-bit integer")
    if impl not in KEY_WIDTHS:
        raise ValueError(f"key implementation must be one of {IMPLS}, got "
                         f"{impl!r}")
    pair = [0, seed & M32]
    return np.array(pair * (KEY_WIDTHS[impl] // 2), dtype=np.uint32)


def _fold_in2(keys, d):
    k0, k1 = _words(keys)
    return _keys(*threefry2x32(k0, k1, np.zeros_like(d), d))


def fold_in(keys, data) -> np.ndarray:
    """`jax.random.fold_in`: threefry2x32(key, (0, data)), on each half of
    an rbg key.  keys [..., W]; data an integer or an integer array
    broadcast against keys[..., 0]."""
    d = np.asarray(data, dtype=np.int64) & M32
    return _per_half(lambda k: _fold_in2(k, d), keys)


def _split2(keys, n: int):
    k0, k1 = _words(keys)
    i = np.arange(n, dtype=np.int64)
    return _keys(*threefry2x32(k0[..., None], k1[..., None],
                               np.zeros_like(i), i))


def split(keys, n: int = 2) -> np.ndarray:
    """`jax.random.split(key, n)`: key i is threefry2x32(key, (0, i)), on
    each half of an rbg key.  keys [..., W] -> [..., n, W]."""
    return _per_half(lambda k: _split2(k, n), keys)


def hash_seed(keys) -> np.ndarray:
    """The JAX package's `hash_seed` of each key: keys [..., W] -> uint32
    [...]; s = 0x2545F491, then s = (s ^ k_i) * (0x9E3779B1 + 2 i) mod
    2**32 for each word i of the key."""
    k = np.asarray(keys, dtype=np.uint32).astype(np.uint64)
    impl_of(k)  # raises unless the keys have 2 or 4 words
    seed = np.full(k.shape[:-1], 0x2545F491, dtype=np.uint64)
    for i in range(k.shape[-1]):
        seed = ((seed ^ k[..., i]) * np.uint64(0x9E3779B1 + 2 * i)) & M32
    return seed.astype(np.uint32)


# ----------------------------------------------------------- the draws

def counters(n: int, start: int = 0, seg_len=None, seg_stride=None) -> tuple:
    """The counter layout (start, seg_len, seg_stride) of a draw of n
    elements: element j draws the bits of counter start + (j // seg_len) *
    seg_stride + j % seg_len.  The defaults, one segment from 0, give the
    flat positions 0..n-1 of a shape.  A rank's rows [r0, r0 + local) of
    a batch-major [rows, ...] site are one segment from r0 * (elements per
    row); its part of a time-major [T, rows, W] site is T segments of
    local * W at stride rows * W from r0 * W.  Contiguous counters (a
    segment of n or more, or a stride equal to the segment) come back as
    one segment of n."""
    seg_len = n if seg_len is None else int(seg_len)
    seg_stride = seg_len if seg_stride is None else int(seg_stride)
    start = int(start)
    if start < 0 or seg_len < 1 or seg_stride < 0:
        raise ValueError(f"threefry counters: start {start}, seg_len "
                         f"{seg_len}, seg_stride {seg_stride}")
    if seg_len >= n or seg_stride == seg_len:
        return start, n, n
    return start, seg_len, seg_stride


def random_bits_plain(keys, n: int, device="cpu", start: int = 0,
                      seg_len=None, seg_stride=None) -> torch.Tensor:
    """Kernel T's bits in plain PyTorch: for each of the K keys of
    keys [K, 2], the 32-bit bits of n counters (`counters`; by default the
    flat positions 0..n-1); int64 [K, n] holding uint32 values."""
    start, seg_len, seg_stride = counters(n, start, seg_len, seg_stride)
    k0, k1 = (torch.from_numpy(w).to(device)[:, None] for w in _words(keys))
    out = torch.empty(k0.shape[0], n, dtype=torch.int64, device=device)
    chunk = (_CHUNK * torch.get_num_threads() if out.device.type == "cpu"
             else n)
    for lo in range(0, n, chunk):
        j = torch.arange(lo, min(lo + chunk, n), dtype=torch.int64,
                         device=device)
        idx = (start + j if seg_len >= n else
               start + j // seg_len * seg_stride + j % seg_len)
        y0, y1 = threefry2x32(k0, k1, idx >> 32, idx & M32)
        out[:, lo:lo + j.numel()] = y0 ^ y1
    return out


_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a, m: int):
    """(hi, lo) words of a * m for uint32 a (int64 numpy array or tensor)
    and a uint32 constant m: 16-bit halves, so that nothing leaves the
    int64 range."""
    m0, m1 = m & 0xFFFF, m >> 16
    a0, a1 = a & 0xFFFF, a >> 16
    mid = a1 * m0 + a0 * m1                 # < 2**33
    low = a0 * m0 + ((mid & 0xFFFF) << 16)  # < 2**33
    return (a1 * m1 + (mid >> 16) + (low >> 32)) & M32, low & M32


def philox4x32(k0, k1, x0, x1, x2, x3) -> tuple:
    """Philox4x32 with 10 rounds, as XLA expands it (its prng.cc
    `Philox4x32`): int64 numpy arrays or torch tensors of uint32 values,
    broadcast together.  Returns the four output words."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(x0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(x2, _PHILOX_M[1])
        x0, x1, x2, x3 = hi1 ^ x1 ^ k0, lo1, hi0 ^ x3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & M32
        k1 = (k1 + _PHILOX_W[1]) & M32
    return x0, x1, x2, x3


def philox_bits_plain(keys, n: int, device="cpu", start: int = 0,
                      seg_len=None, seg_stride=None) -> torch.Tensor:
    """Kernel P's bits in plain PyTorch: `lax.rng_bit_generator(key, (m,))`
    (XLA's Philox, see the top) for each of the K rbg keys of keys [K, 4],
    at n elements of that draw (`counters`; by default 0..n-1, which is
    the draw of n); int64 [K, n] holding uint32 values.  Element e is word
    e % 4 of counter e // 4."""
    start, seg_len, seg_stride = counters(n, start, seg_len, seg_stride)
    k = [torch.from_numpy(w).to(device)[:, None]
         for w in _words(keys, 4)]
    out = torch.empty(k[0].shape[0], n, dtype=torch.int64, device=device)
    chunk = (_CHUNK * torch.get_num_threads() if out.device.type == "cpu"
             else n)
    for lo in range(0, n, chunk):
        j = torch.arange(lo, min(lo + chunk, n), dtype=torch.int64,
                         device=device)
        e = (start + j if seg_len >= n else
             start + j // seg_len * seg_stride + j % seg_len)
        i = e >> 2
        # the counter: (s1 + i) mod 2**64 in 32-bit words, and s0 plus
        # that sum's carry out
        c_lo = (k[2] + (i & M32))
        c_hi = (k[3] + (i >> 32) + (c_lo >> 32))
        carry = c_hi >> 32
        hi_lo = k[0] + carry
        hi_hi = (k[1] + (hi_lo >> 32)) & M32
        words = philox4x32(k[0], k[1], c_lo & M32, c_hi & M32, hi_lo & M32,
                           hi_hi)
        w = e & 3
        out[:, lo:lo + j.numel()] = torch.where(
            w == 0, words[0], torch.where(w == 1, words[1], torch.where(
                w == 2, words[2], words[3])))
    return out


def bits_plain(keys, n: int, device="cpu", start: int = 0, seg_len=None,
               seg_stride=None) -> torch.Tensor:
    """The plain bits of keys [K, W] of either implementation."""
    fn = (random_bits_plain if impl_of(keys) == "threefry"
          else philox_bits_plain)
    return fn(keys, n, device, start, seg_len, seg_stride)


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """`jax.random.uniform`'s float32 in [0, 1) from 32-bit bits (any
    integer dtype holding them): ((bits >> 9) | 0x3F800000) as a float,
    minus 1."""
    mant = ((bits.to(torch.int64) & M32) >> 9) | 0x3F800000
    return mant.to(torch.int32).view(torch.float32) - 1.0


def keep_mask_plain(keys, n: int, p: float, device="cpu", start: int = 0,
                    seg_len=None, seg_stride=None) -> torch.Tensor:
    """Kernel T's (threefry keys [K, 2]) or kernel P's (rbg keys [K, 4])
    keep mask in plain PyTorch: uniform < p (p rounded to float32 first,
    as `jax.random.bernoulli` does) at n counters (`counters`), bool
    [K, n]."""
    p32 = torch.tensor(p, dtype=torch.float32, device=device)
    return bits_to_unit(bits_plain(keys, n, device, start, seg_len,
                                   seg_stride)) < p32


def _stack(keys, shape, layout: dict) -> tuple:
    """(flat keys [K, W], their leading shape, the counter layout) of a
    draw of `shape`: RowKeys give their rows' segment (and take no other
    layout)."""
    if isinstance(keys, RowKeys):
        if any(v is not None for v in layout.values()):
            raise ValueError("RowKeys draw their rows' counters; give "
                             "plain keys with a counter layout")
        if not (0 <= keys.r0 and keys.r0 + shape[0] <= keys.rows):
            raise ValueError(f"rows [{keys.r0}, {keys.r0 + shape[0]}) of "
                             f"a batch of {keys.rows}")
        layout = {"start": keys.r0 * math.prod(shape[1:])}
        keys = keys.keys
    k = np.asarray(keys, dtype=np.uint32)
    given = {name: v for name, v in layout.items() if v is not None}
    return k.reshape(-1, k.shape[-1]), k.shape[:-1], given


def _kernel(keys):
    """The draw's wrappers (bits, keep mask) for keys of either
    implementation: kernel T's or kernel P's."""
    if impl_of(keys) == "threefry":
        from ..ops.cuda import threefry
        return threefry.threefry_bits, threefry.threefry_keep_mask
    from ..ops.cuda import philox
    return philox.philox_bits, philox.philox_keep_mask


def random_bits(keys, shape, device="cuda", *, start=None, seg_len=None,
                seg_stride=None) -> torch.Tensor:
    """32-bit bits of each key of keys [..., W] over `shape`: a [..., *shape]
    int32 tensor holding the bits (on the card from kernel T, or kernel P
    for rbg keys) at the flat positions of shape, or at the counters
    start, seg_len, seg_stride (`counters`); RowKeys draw their rows of
    the global batch."""
    bits, _ = _kernel(keys)
    flat, lead, layout = _stack(keys, shape, dict(
        start=start, seg_len=seg_len, seg_stride=seg_stride))
    n = math.prod(shape)
    return bits(flat, n, device, **layout).view(*lead, *shape)


def uniform(keys, shape, minval: float, maxval: float,
            device="cuda") -> torch.Tensor:
    """`jax.random.uniform(key, shape, float32, minval, maxval)` of each key
    of keys [..., W]: [..., *shape] float32.  minval and maxval are rounded
    to float32 first.  f * (maxval - minval) + minval is rounded once, as
    XLA's fused multiply-add rounds it: the float64 product of two float32
    values is exact, and so is its sum with minval for the symmetric
    bounds of the initialisers (f - 1/2 times the range)."""
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=device)
    f = bits_to_unit(random_bits(keys, shape, device))
    fused = f.double() * (hi - lo).double() + lo.double()
    return torch.maximum(lo, fused.float())


def bernoulli(keys, p: float, shape, device="cuda", *, start=None,
              seg_len=None, seg_stride=None) -> torch.Tensor:
    """`jax.random.bernoulli(key, p, shape)` of each key of keys [..., W]:
    [..., *shape] bool (on the card from kernel T, or kernel P for rbg
    keys); at the counters start, seg_len, seg_stride where given
    (`counters`), and at the rank's rows of the global batch for
    RowKeys."""
    _, keep_mask = _kernel(keys)
    flat, lead, layout = _stack(keys, shape, dict(
        start=start, seg_len=seg_len, seg_stride=seg_stride))
    n = math.prod(shape)
    return keep_mask(flat, n, p, device, **layout).view(*lead, *shape)
