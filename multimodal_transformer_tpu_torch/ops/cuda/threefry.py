"""Kernel T: jax.random's threefry2x32 bits and bernoulli keep masks
(csrc/threefry.cu).

The JAX package computes these in XLA (`jax.random.uniform`,
`jax.random.bernoulli`), not in Pallas, so kernel T replaces no TPU kernel.
The port draws its initial weights from the bits (utils/init.py) and, on
the "threefry" dropout route, every site's keep mask, both along the JAX
key tree (utils/prng.py).

`threefry_bits(keys, n, device)` gives, for each key of keys [K, 2] (numpy
uint32), the bits of the n flat positions 0..n-1 as int32 [K, n];
`threefry_keep_mask(keys, n, p, device)` gives uniform < p as bool [K, n].
Both take a counter layout (`start`, `seg_len`, `seg_stride`; utils/prng.py
`counters`): element j draws counter start + (j // seg_len) * seg_stride +
j % seg_len, so that a data-parallel rank draws its rows of a global draw
(the defaults give 0..n-1).  The kernel computes the counters itself.
On a CUDA device each launches the kernel once for each block of up to 480
keys (the keys travel in its parameters); on the CPU each runs its plain version,
`utils/prng.py random_bits_plain` / `keep_mask_plain`.  Nothing falls back:
a launch that fails raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...utils import prng
from ..dispatch import use_kernel
from . import _build

MODE_BITS, MODE_KEEP = 0, 1
MAX_KEYS = 480  # keys a launch (csrc/threefry.cu kMaxKeys)

# Launches since the last reset: one for each block of MAX_KEYS keys.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def launch_blocks(entry: str, max_keys: int, keys: np.ndarray, n: int,
                  mode: int, p: float, out: torch.Tensor,
                  layout: tuple) -> int:
    """Call the C entry `entry` (kernel T's, or kernel P's: the same
    arguments) once for each block of max_keys keys, with that block's
    output rows; returns the number of launches."""
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    fn = getattr(_build.load(), entry)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        for k0 in range(0, keys.shape[0], max_keys):
            block = keys[k0:k0 + max_keys]
            rc = fn(block.ctypes.data_as(ctypes.c_void_p), block.shape[0], n,
                    mode, p, out[k0:k0 + max_keys].data_ptr(), stream,
                    *layout)
            _build.check(rc, entry)
    return -(-keys.shape[0] // max_keys)


def check_keys(keys, n: int, width: int, what: str) -> np.ndarray:
    """keys as numpy uint32 [K >= 1, width]; raises on another shape or
    n < 1."""
    keys = np.asarray(keys, dtype=np.uint32)
    if keys.ndim != 2 or keys.shape[1] != width or keys.shape[0] < 1:
        raise ValueError(f"{what}: keys must be [K >= 1, {width}], got "
                         f"{keys.shape}")
    if n < 1:
        raise ValueError(f"{what}: n must be positive, got {n}")
    return keys


def _launch(keys: np.ndarray, n: int, mode: int, p: float,
            out: torch.Tensor, layout: tuple) -> None:
    global launches
    launches += launch_blocks("mmtx_threefry", MAX_KEYS, keys, n, mode, p,
                              out, layout)


def threefry_bits(keys, n: int, device="cuda", *, start: int = 0,
                  seg_len: int | None = None,
                  seg_stride: int | None = None) -> torch.Tensor:
    """The bits of n counters (0..n-1 by default) under each key, int32
    [K, n]."""
    keys = check_keys(keys, n, 2, "threefry")
    layout = prng.counters(n, start, seg_len, seg_stride)
    out = torch.empty(keys.shape[0], n, dtype=torch.int32, device=device)
    if not use_kernel(out):
        bits = prng.random_bits_plain(keys, n, out.device, *layout)
        return (((bits + 2 ** 31) & prng.M32) - 2 ** 31).to(torch.int32)
    _launch(keys, n, MODE_BITS, 0.0, out, layout)
    return out


def threefry_keep_mask(keys, n: int, p: float, device="cuda", *,
                       start: int = 0, seg_len: int | None = None,
                       seg_stride: int | None = None) -> torch.Tensor:
    """jax.random.bernoulli(key, p, (n,)) of each key at n counters (0..n-1
    by default), bool [K, n]."""
    keys = check_keys(keys, n, 2, "threefry")
    layout = prng.counters(n, start, seg_len, seg_stride)
    out = torch.empty(keys.shape[0], n, dtype=torch.bool, device=device)
    if not use_kernel(out):
        return prng.keep_mask_plain(keys, n, p, out.device, *layout)
    _launch(keys, n, MODE_KEEP, p, out, layout)
    return out
