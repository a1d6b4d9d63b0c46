"""Wall-clock windowing + padding pipeline (numpy only).

Counterpart of `multimodal_transformer_tpu/data/windowing.py` (reference
MFT/train.py:371-514), array for array:

  window_channel   NaN -> 0 scrub; frames grouped into windows of
                   `window_size` seconds by timestamp, each window emitted
                   `oversample` times, empty windows kept, the trailing
                   partial window dropped;
  window_ratings   mean rating per window, trailing partial dropped; an
                   empty rating window raises;
  construct_input  every channel and the ratings cut to the common minimum
                   window count per video;
  pad_input        dense [V, W_max, F_max, D] float32 per channel;
  pad_rating       [V, W_max] float32 targets.

The reference's loop walks the frames with an edge that accumulates in
float64 (`current_time += window_size`): a frame joins the current window
while its time is <= current_time + window_size, and otherwise closes it
(and every empty window after it) first.  `window_bounds` computes the same
assignment without the loop: the edges are the running sum of window_size,
frame i's first window with an edge at or past its time is
searchsorted(edges, t_i), and its window is the running maximum of those
(frames with earlier times than a frame before them stay in the open
window, as in the loop).  As in the JAX package, `window_channel` first
asks the native library (data/native_loader.py) for the loop's assignment
in C++, and takes `window_bounds` where the library is unavailable.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from . import native_loader
from .send import SendDataset


def window_bounds(times: np.ndarray, window_size: float) -> np.ndarray:
    """Start index of every completed window, plus the end of the last one:
    window k holds frames [bounds[k], bounds[k + 1])."""
    t = np.asarray(times, dtype=np.float64).reshape(-1)
    if len(t) == 0:
        return np.zeros(1, np.int64)
    if not np.all(np.isfinite(t)):
        raise ValueError("window timestamps must be finite")
    t_max = max(float(t.max()), 0.0)
    n_edges = int(t_max // window_size) + 2
    edges = np.cumsum(np.full(n_edges, float(window_size)))
    while edges[-1] < t_max:  # rounding of the running sum
        edges = np.cumsum(np.full(2 * len(edges), float(window_size)))
    window = np.maximum.accumulate(np.searchsorted(edges, t, side="left"))
    # windows 0 .. window[-1] - 1 are closed; the last frame's stays open
    return np.searchsorted(window, np.arange(window[-1] + 1), side="left")


def window_channel(features: np.ndarray, times: np.ndarray,
                   window_size: float, oversample: int) -> List[np.ndarray]:
    """Group per-frame features [T, D] into wall-clock windows: a list of
    [n_frames_w, D] arrays (0 rows for an empty window), each window
    `oversample` times in a row.  The native assignment
    (native_loader.window_assign, the loop in C++) runs first, as in the
    JAX package; window_bounds where it gives none."""
    feats = np.nan_to_num(np.asarray(features, dtype=np.float32), nan=0.0,
                          posinf=np.inf, neginf=-np.inf)
    times = np.asarray(times, dtype=np.float64).reshape(-1)
    assign = native_loader.window_assign(times, window_size)
    if assign is not None:
        return [feats[s:s + c] for s, c in zip(*assign)
                for _ in range(oversample)]
    bounds = window_bounds(times, window_size)
    return [feats[s:e] for s, e in zip(bounds[:-1], bounds[1:])
            for _ in range(oversample)]


def window_ratings(ratings: np.ndarray, times: np.ndarray,
                   window_size: float) -> List[float]:
    """Mean rating per window (ratingInputHelper); trailing partial dropped."""
    r = np.asarray(ratings, dtype=np.float64).reshape(-1)
    bounds = window_bounds(times, window_size)
    empty = np.flatnonzero(bounds[1:] == bounds[:-1])
    if len(empty):
        # the reference crashes here with a bare ZeroDivisionError; the
        # message names the window's start, the loop's current_time
        k = int(empty[0])
        start = (float(np.cumsum(np.full(k, float(window_size)))[-1])
                 if k else 0.0)
        raise ValueError(
            f"empty rating window at t={start:.2f}s "
            f"(gap in rating timestamps larger than the "
            f"{window_size}s window)")
    return [float(r[s:e].mean()) for s, e in zip(bounds[:-1], bounds[1:])]


def construct_input(dataset: SendDataset, window_size: Dict[str, float],
                    channels: Sequence[str]
                    ) -> Tuple[Dict[str, List[List[np.ndarray]]],
                               List[List[float]]]:
    """Per-video windowing for every channel + ratings, truncated to the
    common minimum window count (constructInput, train.py:432-454)."""
    features: Dict[str, List[List[np.ndarray]]] = {c: [] for c in channels}
    all_ratings: List[List[float]] = []
    for v in range(len(dataset)):
        min_len = None
        per_channel = {}
        for c in channels:
            oversample = int(window_size[c] / window_size["ratings"])
            if oversample < 1:
                # the reference silently emits zero windows here (int(1/5)
                # when a channel's window is shorter than the ratings')
                raise ValueError(
                    f"channel {c!r} window ({window_size[c]}s) is smaller "
                    f"than the ratings window ({window_size['ratings']}s); "
                    "oversample would be 0 and every video would have zero "
                    "windows")
            wins = window_channel(dataset.data[c][v], dataset.timers[c][v],
                                  window_size[c], oversample)
            per_channel[c] = wins
            if min_len is None or len(wins) < min_len:
                min_len = len(wins)
        ratings = window_ratings(dataset.data["ratings"][v],
                                 dataset.timers["ratings"][v],
                                 window_size["ratings"])
        if len(ratings) < min_len:
            min_len = len(ratings)
        for c in channels:
            features[c].append(per_channel[c][:min_len])
        all_ratings.append(ratings[:min_len])
    return features, all_ratings


def pad_input(features: Dict[str, List[List[np.ndarray]]],
              channels: Sequence[str], dims: Dict[str, int]
              ) -> Tuple[Dict[str, np.ndarray], List[int]]:
    """Dense [V, W_max, F_max, D] per channel + per-video window counts."""
    out: Dict[str, np.ndarray] = {}
    seq_lens: List[int] = []
    for c in channels:
        vids = features[c]
        n_windows = [len(v) for v in vids]
        f_max = max(max((len(w) for v in vids for w in v), default=1), 1)
        arr = np.zeros((len(vids), max(n_windows), f_max, dims[c]),
                       dtype=np.float32)
        for vi, vid in enumerate(vids):
            for wi, w in enumerate(vid):
                arr[vi, wi, :len(w), :] = w
        out[c] = arr
        seq_lens = n_windows
    return out, seq_lens


def pad_rating(ratings: List[List[float]], max_len: int) -> np.ndarray:
    """[V, max_len] float32 zero-padded targets."""
    out = np.zeros((len(ratings), max_len), dtype=np.float32)
    for i, r in enumerate(ratings):
        out[i, :len(r)] = r
    return out


def window_pipeline(dataset: SendDataset, window_size: Dict[str, float],
                    channels: Sequence[str], dims: Dict[str, int]):
    """dataset -> (padded dict, targets [V, W], seq_lens)."""
    feats, ratings = construct_input(dataset, window_size, channels)
    padded, seq_lens = pad_input(feats, channels, dims)
    targets = pad_rating(ratings, max(seq_lens))
    return padded, targets, seq_lens
