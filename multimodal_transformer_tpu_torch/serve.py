"""Serving API: windowed inputs -> per-video valence traces.

Counterpart of `multimodal_transformer_tpu/serve.py` `ValencePredictor`, for
any of the five families: videos are grouped into fixed-shape length
buckets (padding-invariant "key_query" masking is forced), run through the
model on the card unless the caller names another device (optionally in
bf16), and each trace is returned in float32, cut to its true length.

    module = build_model(cfg, seed=0, device="cuda")
    predictor = ValencePredictor(cfg, module)
    traces = predictor.predict_padded(data, seq_lens)

    predictor = ValencePredictor.from_checkpoint("MFT-VAL-88.pth", "MFT")
    traces = predictor.predict_dataset(load_send([...], data_dir, "Test"))
    # {"165_2": np.array([...valence per rating window...]), ...}

On the card, a family's encoders take kernel A on buckets of up to 512
windows and, on the buckets past it (544, 576, ... with the default
time_multiple of 32), the flash route: layer by layer with attention
through kernel 11 (ops/dispatch.py `encoder_route`).

`from_checkpoint` reads a reference-layout `.pth` or the JAX package's
msgpack `.ckpt` (engine/checkpoint.py `load_model`: the configuration from
the file, B1-LSTM's legacy variant and the acoustic window embed from the
weights); `predict_dataset` windows a SendDataset (data/send.py,
data/windowing.py) with the configuration's window sizes.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn

from .data.batching import bucketed_eval_batches
from .data.send import SendDataset
from .data.windowing import window_pipeline
from .engine.checkpoint import load_model
from .engine.csv_io import seq_id_strings
from .models import build_model
from .models.config import ModelConfig


class ValencePredictor:
    def __init__(self, cfg: ModelConfig, module: nn.Module, *,
                 device: torch.device | str = "cuda", batch_size: int = 32,
                 time_multiple: int = 32, bf16: bool = True):
        if cfg.mask_mode != "key_query":
            cfg = dataclasses.replace(cfg, mask_mode="key_query")
        self.cfg = cfg
        self.device = torch.device(device)
        self.batch_size = batch_size
        self.time_multiple = time_multiple
        self.dtype = torch.bfloat16 if bf16 else torch.float32
        # a private copy: the caller's module keeps its device and dtype
        self.module = copy.deepcopy(module).to(device=self.device,
                                               dtype=self.dtype).eval()

    @classmethod
    def from_checkpoint(cls, path: str, family: str,
                        **kw) -> "ValencePredictor":
        """A predictor for a `.pth` or `.ckpt` checkpoint ("key_query"
        masking)."""
        cfg, state = load_model(path, family, mask_mode="key_query")
        with torch.device("meta"):
            module = build_model(cfg)
        module.load_state_dict({k: torch.from_numpy(v)
                                for k, v in state.items()}, assign=True)
        return cls(cfg, module, **kw)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device=self.device, dtype=self.dtype)

    @torch.inference_mode()
    def predict_padded(self, data: Dict[str, np.ndarray],
                       seq_lens: Sequence[int]) -> list:
        """data: mod -> [V, W, F, D] windowed arrays.  Returns the list of
        per-video 1-D float32 traces (true lengths)."""
        V = next(iter(data.values())).shape[0]
        dummy_target = np.zeros((V, max(int(max(seq_lens)), 1)), np.float32)
        out: list = [None] * V
        for batch in bucketed_eval_batches(data, dummy_target, seq_lens,
                                           batch_size=self.batch_size,
                                           time_multiple=self.time_multiple):
            inputs = {m: self._tensor(v) for m, v in batch.data.items()}
            mask = self._tensor(batch.mask)
            pred = self.module(inputs, mask, mask_mode="key_query")
            pred = pred.float().cpu().numpy()
            for row, (vi, ln) in enumerate(zip(batch.indices, batch.lengths)):
                out[vi] = pred[row, :ln, 0].copy()
        return out

    def predict_dataset(self, dataset: SendDataset) -> Dict[str, np.ndarray]:
        """Traces of a loaded SendDataset, keyed by 'subj_vid'."""
        padded, _, seq_lens = window_pipeline(
            dataset, self.cfg.window_size, self.cfg.modalities,
            self.cfg.mod_dimension)
        traces = self.predict_padded(padded, seq_lens)
        return dict(zip(seq_id_strings(dataset.seq_ids), traces))

    def warmup(self, max_windows: int, frames: Dict[str, int]) -> int:
        """Run one batch of every bucket up to max_windows (builds the
        kernels and warms the allocator).  frames: frames per window for
        each modality.  Returns the number of buckets run."""
        n = 0
        t = self.time_multiple
        for bound in range(t, ((max_windows + t - 1) // t) * t + 1, t):
            data = {m: np.zeros((self.batch_size, bound, frames[m],
                                 self.cfg.mod_dimension[m]), np.float32)
                    for m in self.cfg.modalities}
            self.predict_padded(data, [bound] * self.batch_size)
            n += 1
        return n
