"""Kernel P: jax.random's bits and bernoulli keep masks under rbg keys, XLA's
Philox4x32-10 expansion of `lax.rng_bit_generator` (csrc/philox.cu).

The JAX package draws these in XLA when `jax_default_prng_impl` is "rbg"
(its CLI's `--fast_rng`), not in Pallas, so kernel P replaces no TPU
kernel: it is to rbg keys what kernel T (ops/cuda/threefry.py) is to
threefry keys.  The port draws the initial weights' uniform bits and, on
the "threefry" dropout route, every site's keep mask with it, along the JAX
key tree (utils/prng.py).

`philox_bits(keys, n, device)` gives, for each rbg key of keys [K, 4]
(numpy uint32), the bits of elements 0..n-1 of the key's draw as int32
[K, n]; `philox_keep_mask(keys, n, p, device)` gives uniform < p as bool
[K, n].  Both take kernel T's layout of the elements (`start`, `seg_len`,
`seg_stride`; utils/prng.py `counters`): element j draws element start +
(j // seg_len) * seg_stride + j % seg_len of the draw, so that a
data-parallel rank draws its rows of a global draw.  On a CUDA device each
launches the kernel once for each block of up to 240 keys (the keys
travel in its parameters); on the CPU each runs its plain version,
`utils/prng.py philox_bits_plain` / `keep_mask_plain`.  Nothing falls
back: a launch that fails raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ...utils import prng
from ..dispatch import use_kernel
from .threefry import MODE_BITS, MODE_KEEP, check_keys, launch_blocks

MAX_KEYS = 240  # keys a launch (csrc/philox.cu kMaxKeys)

# Launches since the last reset: one for each block of MAX_KEYS keys.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _launch(keys: np.ndarray, n: int, mode: int, p: float,
            out: torch.Tensor, layout: tuple) -> None:
    global launches
    launches += launch_blocks("mmtx_philox", MAX_KEYS, keys, n, mode, p, out,
                              layout)


def philox_bits(keys, n: int, device="cuda", *, start: int = 0,
                seg_len: int | None = None,
                seg_stride: int | None = None) -> torch.Tensor:
    """The bits of n elements (0..n-1 by default) of each key's draw,
    int32 [K, n]."""
    keys = check_keys(keys, n, 4, "philox (rbg keys)")
    layout = prng.counters(n, start, seg_len, seg_stride)
    out = torch.empty(keys.shape[0], n, dtype=torch.int32, device=device)
    if not use_kernel(out):
        bits = prng.philox_bits_plain(keys, n, out.device, *layout)
        return (((bits + 2 ** 31) & prng.M32) - 2 ** 31).to(torch.int32)
    _launch(keys, n, MODE_BITS, 0.0, out, layout)
    return out


def philox_keep_mask(keys, n: int, p: float, device="cuda", *,
                     start: int = 0, seg_len: int | None = None,
                     seg_stride: int | None = None) -> torch.Tensor:
    """jax.random.bernoulli(key, p, (m,)) of each rbg key at n of its
    elements (0..n-1 by default), bool [K, n]."""
    keys = check_keys(keys, n, 4, "philox (rbg keys)")
    layout = prng.counters(n, start, seg_len, seg_stride)
    out = torch.empty(keys.shape[0], n, dtype=torch.bool, device=device)
    if not use_kernel(out):
        return prng.keep_mask_plain(keys, n, p, out.device, *layout)
    _launch(keys, n, MODE_KEEP, p, out, layout)
    return out
