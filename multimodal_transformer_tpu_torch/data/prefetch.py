"""Host -> device prefetch of training batches.

Counterpart of `multimodal_transformer_tpu/data/prefetch.py`.  A host thread
builds the next `depth` batches (the shuffle, the padding and the copies of
`make_batches`) while the card runs the current step.  For a CUDA device it
copies each batch into pinned host memory and from there to the card with
non-blocking copies on a side stream, and records an event; the consumer's
stream waits on that event before it uses the batch, and `record_stream`
keeps the caching allocator from reusing the batch's memory while the
consumer's stream may still read it.  For the CPU the thread only turns the
arrays into tensors.  Batches come out in the order the iterator gives
them, and an exception in the thread is raised in the consumer.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from .batching import Batch


class DevicePrefetcher:
    """Wraps a Batch iterator; yields Batches whose `data`, `target` and
    `mask` are float32 tensors on `device`, `depth` batches staged ahead."""

    _SENTINEL = object()

    def __init__(self, batches: Iterable[Batch], device: torch.device | str,
                 depth: int = 2):
        self.device = torch.device(device)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        cuda = self.device.type == "cuda"
        stream = torch.cuda.Stream(self.device) if cuda else None

        def stage(b: Batch):
            def put(a):
                t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
                if not cuda:
                    return t
                return t.pin_memory().to(self.device, non_blocking=True)

            if not cuda:
                return dataclasses.replace(
                    b, data={m: put(v) for m, v in b.data.items()},
                    target=put(b.target), mask=put(b.mask)), None
            with torch.cuda.device(self.device), torch.cuda.stream(stream):
                staged = dataclasses.replace(
                    b, data={m: put(v) for m, v in b.data.items()},
                    target=put(b.target), mask=put(b.mask))
                event = torch.cuda.Event()
                event.record(stream)
            return staged, event

        def offer(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for b in batches:
                    if not offer(stage(b)):
                        return  # the consumer left; drop staged batches
            except BaseException as e:  # raised again in the consumer
                self._err = e
            finally:
                offer(self._SENTINEL)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Stop the thread and drop the staged batches (call when leaving
        the iteration early)."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=10)

    def __iter__(self) -> Iterator[Batch]:
        try:
            while True:
                item = self._q.get()
                if item is self._SENTINEL:
                    if self._err is not None:
                        raise self._err
                    return
                batch, event = item
                if event is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(event)
                    for t in [*batch.data.values(), batch.target, batch.mask]:
                        t.record_stream(stream)
                yield batch
        finally:
            self.close()
