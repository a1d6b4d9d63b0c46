"""Training batches and bucketed fixed-shape eval batches (numpy only).

Re-homed from `multimodal_transformer_tpu/data/batching.py`: that package's
`data/__init__` imports the SENDv1 reader, which needs pandas.  Same
semantics, batch for batch.  `make_batches` is the reference's batcher:
optionally shuffled indices, chunks of `batch_size`, each chunk sorted by
length (descending, stable) and cut to its longest video.
`bucketed_eval_batches` groups videos by their length rounded up to
`time_multiple`, and every batch has exactly `batch_size` rows (the last
partial batch of a bucket cycles its videos, with their mask and target
zeroed).  Masks are trailing (1 for the first `length` steps, then 0).
`len_to_mask`, `pad_and_merge` and `seq_collate_dict` are the reference's
collate helpers (MFT/datasets.py:193-239).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Batch:
    data: Dict[str, np.ndarray]   # mod -> [B, T, F, D]
    target: np.ndarray            # [B, T, 1]
    mask: np.ndarray              # [B, T, 1]
    lengths: List[int]            # real rows only
    indices: Optional[List[int]] = None  # original video indices


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _take_time(a: np.ndarray, idx: List[int], t: int) -> np.ndarray:
    """a[idx] with the time axis sliced or zero-padded to exactly t."""
    out = a[idx][:, :t]
    if out.shape[1] < t:
        pad = [(0, 0)] * out.ndim
        pad[1] = (0, t - out.shape[1])
        out = np.pad(out, pad)
    return out


def make_batches(data: Dict[str, np.ndarray], target: np.ndarray,
                 seq_lens: Sequence[int], batch_size: int = 25,
                 shuffle: bool = False,
                 rng: Optional[np.random.RandomState] = None,
                 pad_time_to: Optional[int] = None) -> Iterator[Batch]:
    """Reference-semantics batches.  data: mod -> [V, W, F, D]; target:
    [V, W]; seq_lens: windows per video; rng: the shuffle's RandomState
    (numpy's global one when None); pad_time_to: round each batch's length
    up to a multiple (valid only with key-masked attention)."""
    n = target.shape[0]
    index = list(range(n))
    if shuffle:
        (rng or np.random).shuffle(index)
    for i in range(0, n, batch_size):
        chunk = index[i:i + batch_size]
        lens = [int(seq_lens[j]) for j in chunk]
        order = sorted(range(len(chunk)), key=lambda k: -lens[k])
        chunk = [chunk[k] for k in order]
        lens = [lens[k] for k in order]
        t_max = max(lens)
        if pad_time_to is not None:
            t_max = _round_up(t_max, pad_time_to)
        batch_data = {m: _take_time(a, chunk, t_max) for m, a in data.items()}
        tgt = _take_time(target, chunk, t_max)[..., None].astype(np.float32)
        mask = np.zeros((len(chunk), t_max, 1), dtype=np.float32)
        for bi, ln in enumerate(lens):
            mask[bi, :ln] = 1.0
        yield Batch(batch_data, tgt, mask, lens, list(chunk))


def len_to_mask(lengths: Sequence[int]) -> np.ndarray:
    """[B, T_max, 1] boolean mask (reference len_to_mask)."""
    t_max = max(lengths)
    ar = np.arange(t_max)[None, :] < np.asarray(lengths)[:, None]
    return ar[:, :, None]


def pad_and_merge(sequences: Sequence[np.ndarray],
                  max_len: Optional[int] = None) -> np.ndarray:
    """Zero-pad [T_i, D] sequences into one [B, T_max, D] float32 batch."""
    dims = sequences[0].shape[1]
    lengths = [len(s) for s in sequences]
    if max_len is None:
        max_len = max(lengths)
    out = np.zeros((len(sequences), max_len, dims), np.float32)
    for i, s in enumerate(sequences):
        out[i, :lengths[i]] = s[:max_len]
    return out


def seq_collate_dict(items: List[Dict[str, np.ndarray]]):
    """Collate dict items (with a 'length' key) into padded batch + mask
    (reference seq_collate_dict): sorts by length descending."""
    modalities = [k for k in items[0] if k != "length"]
    items = sorted(items, key=lambda d: d["length"], reverse=True)
    lengths = [d["length"] for d in items]
    batch = {m: pad_and_merge([np.asarray(d[m]) for d in items],
                              max(lengths)) for m in modalities}
    return batch, len_to_mask(lengths), lengths


def bucketed_eval_batches(data: Dict[str, np.ndarray], target: np.ndarray,
                          seq_lens: Sequence[int], batch_size: int = 32,
                          time_multiple: int = 32) -> Iterator[Batch]:
    """Group videos by padded-length bucket, then emit fixed-shape batches.

    data: mod -> [V, W, F, D]; target: [V, W]; seq_lens: windows per video.
    `lengths`/`indices` of each batch cover only its real rows."""
    n = target.shape[0]
    buckets: Dict[int, List[int]] = {}
    for v in range(n):
        b = _round_up(max(int(seq_lens[v]), 1), time_multiple)
        buckets.setdefault(b, []).append(v)
    for bound in sorted(buckets):
        vids = buckets[bound]
        for i in range(0, len(vids), batch_size):
            chunk = vids[i:i + batch_size]
            real = len(chunk)
            lens = [int(seq_lens[j]) for j in chunk]
            padded_chunk = (chunk if real == batch_size
                            else list(np.resize(chunk, batch_size)))
            batch_data = {m: _take_time(a, padded_chunk, bound)
                          for m, a in data.items()}
            tgt = _take_time(target, padded_chunk,
                             bound)[..., None].astype(np.float32)
            tgt[real:] = 0.0
            mask = np.zeros((batch_size, bound, 1), dtype=np.float32)
            for bi, ln in enumerate(lens):
                mask[bi, :ln] = 1.0
            yield Batch(batch_data, tgt, mask, lens, list(chunk))
