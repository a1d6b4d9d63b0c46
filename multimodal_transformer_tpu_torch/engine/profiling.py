"""Tracing and profiling utilities.

Counterpart of `multimodal_transformer_tpu/engine/profiling.py`, on
torch.profiler and the CUDA caching allocator:

  * trace(log_dir):  a torch.profiler session over the block (CPU
                     activities, and CUDA where a card is present) that
                     exports a Chrome trace (`*.pt.trace.json`, readable in
                     Perfetto or chrome://tracing) into log_dir at exit;
                     on a card its window is padded (`pad_window`: 128
                     throwaway kernels first, named by PAD_KERNEL_MARK,
                     and 50 ms of idle card at each end), so that it
                     holds every kernel the block ran;
  * StepTimer:       wall-clock time of each step it wraps with summary
                     statistics (n, mean, p50, p95, total), for train-loop
                     telemetry without a tracer; on a card it synchronizes
                     on entry and exit, so that a sample covers the card's
                     work that the step queued and nothing queued before;
  * device_memory_stats(): bytes in use and the peak per CUDA device, {}
                     without a card.

    with trace("./traces"):
        predictor.predict_padded(data, seq_lens)
    timer = StepTimer("train")
    for batch in batches:
        with timer:
            engine.train_step(batch)
    print(timer.summary(), device_memory_stats())
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Dict, List, Optional

import numpy as np
import torch

# torch.profiler keeps a kernel's record only if its GPU timestamp falls
# inside the session's window on the host's clock.  On an H100 host, once a
# process had run a few profiled phases, the first 2-12 kernel records of
# every session came with times outside it (the profiler's "Out-of-range"
# count) and were dropped, and a session's GPU times could sit up to 3.8 ms
# early against their launches.  So a window opens with PAD_KERNELS
# throwaway kernels, which take those first records, and WINDOW_PAD_S of
# idle card at each end.
PAD_KERNELS = 128
WINDOW_PAD_S = 0.05
# in the name of the throwaway kernels (an int32 bitwise_not), by which a
# reader of the trace leaves them out
PAD_KERNEL_MARK = "bitwise_not"


def _sync() -> None:
    # a process that never touched the card has no work queued on it
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def pad_window(start: bool) -> None:
    """Called right after a profiler session starts (start=True: the
    throwaway kernels first) and right before it stops: waits for the
    card's queued work, then WINDOW_PAD_S.  Nothing without a card."""
    if not torch.cuda.is_available():
        return
    if start:
        # uninitialised: filling it would launch one more kernel
        z = torch.empty(1, dtype=torch.int32, device=torch.device(
            "cuda", torch.cuda.current_device()))
        for _ in range(PAD_KERNELS):
            z.bitwise_not_()
    _sync()
    time.sleep(WINDOW_PAD_S)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; its Chrome trace lands in log_dir at exit (also
    when the block raises).  Yields the torch.profiler.profile."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    pad_window(start=True)
    try:
        yield prof
    finally:
        pad_window(start=False)
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"{socket.gethostname()}_{os.getpid()}."
                     f"{time.time_ns()}.pt.trace.json"))


class StepTimer:
    def __init__(self, name: str = "step"):
        self.name = name
        self.samples: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        _sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        self.samples.append(time.perf_counter() - self._t0)
        return False

    def summary(self) -> Dict[str, float]:
        if not self.samples:
            return {}
        a = np.asarray(self.samples)
        return {"n": len(a), "mean_ms": float(a.mean() * 1e3),
                "p50_ms": float(np.percentile(a, 50) * 1e3),
                "p95_ms": float(np.percentile(a, 95) * 1e3),
                "total_s": float(a.sum())}


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """{"cuda:i": {"bytes_in_use", "peak_bytes_in_use"}} of the caching
    allocator on every CUDA device; {} without a card."""
    if not torch.cuda.is_available():
        return {}
    return {str(torch.device("cuda", i)): {
        "bytes_in_use": int(torch.cuda.memory_allocated(i)),
        "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(i))}
        for i in range(torch.cuda.device_count())}
