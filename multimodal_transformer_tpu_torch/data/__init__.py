"""Host data layer of the PyTorch port (numpy only, no pandas)."""

from .batching import (Batch, bucketed_eval_batches, len_to_mask,
                       make_batches, pad_and_merge, seq_collate_dict)
from .send import SCHEMA, SendDataset, load_send
from .synthetic import generate_synthetic_send
from .windowing import construct_input, pad_input, pad_rating, window_pipeline

__all__ = ["Batch", "SCHEMA", "SendDataset", "bucketed_eval_batches",
           "construct_input", "generate_synthetic_send", "len_to_mask",
           "load_send", "make_batches", "pad_and_merge", "pad_input",
           "pad_rating", "seq_collate_dict", "window_pipeline"]
