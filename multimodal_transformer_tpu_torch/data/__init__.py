"""Host data layer of the PyTorch port (numpy only)."""

from .batching import Batch, bucketed_eval_batches, make_batches

__all__ = ["Batch", "bucketed_eval_batches", "make_batches"]
