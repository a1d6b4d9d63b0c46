"""Training engine: one Adam step per batch, epoch loops, reference logs.

Counterpart of the training part of `multimodal_transformer_tpu/engine/
train_engine.py` `Engine` (reference MFT/train.py:110-160):
  * loss = MSE(sum) over the masked batch, divided by sum(lengths) for the
    gradient step;
  * one Adam step per batch with the scheduler's current learning rate;
  * `Batch:` / `Epoch:` log lines byte-identical to the reference's.

Mixed precision (train_dtype=torch.bfloat16) casts the float32 master
parameters and the inputs to bf16 INSIDE the autograd graph, so the
gradients flow back through the casts and arrive in float32 at the masters;
the loss is summed in float32.

Every step draws its dropout seeds with `seed_fn(step, T)` -> DropoutSeeds
(ops/seeds.py), where step counts the engine's steps from 0 and T is the
batch's length; the default draws them from the engine's torch.Generator.
Evaluation, checkpoints, resume, guards and prefetching are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.func import functional_call

from ..data.batching import Batch, make_batches
from ..models import ModelConfig, build_model
from ..models.families import ENCODER_LAYERS
from ..ops.seeds import DropoutSeeds
from .optim import ReduceLROnPlateau, make_adam


class Engine:
    """Trains one (family, modalities) configuration on one device (the
    card unless the caller names another)."""

    def __init__(self, cfg: ModelConfig, lr: float = 1e-4,
                 weight_decay: float = 1e-4, seed: int = 1,
                 train_dtype: Optional[torch.dtype] = None,
                 device: torch.device | str = "cuda", *, logger=None,
                 seed_fn: Optional[Callable[[int, int], DropoutSeeds]] = None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.logger = logger
        self.train_dtype = train_dtype
        self.module = build_model(
            cfg, generator=torch.Generator().manual_seed(seed)).to(self.device)
        self.module.train()
        self.optimizer = make_adam(self.module.parameters(), lr, weight_decay)
        self.scheduler = ReduceLROnPlateau(lr=lr)
        self.generator = torch.Generator().manual_seed(seed)
        self.seed_fn = seed_fn or self._draw_seeds
        self.steps = 0
        self._epoch = 0

    def _draw_seeds(self, step: int, T: int) -> DropoutSeeds:
        return DropoutSeeds.draw(self.cfg.modalities, ENCODER_LAYERS, T,
                                 self.generator)

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(device=self.device, dtype=dtype or torch.float32)

    def batch_loss(self, batch: Batch, seeds: DropoutSeeds, *,
                   plain: bool = False) -> torch.Tensor:
        """Sum of squared errors of one batch (float32, differentiable in
        the module's parameters).  The batch's arrays may be numpy arrays
        or tensors already on the device."""
        dt = self.train_dtype
        data = {m: self._tensor(v, dt) for m, v in batch.data.items()}
        mask = self._tensor(batch.mask, dt)
        target = self._tensor(batch.target)
        kwargs = {"seeds": seeds, "plain": plain}
        if dt is None:
            pred = self.module(data, mask, **kwargs)
        else:
            params = {k: v.to(dt) for k, v in self.module.named_parameters()}
            pred = functional_call(self.module, params, (data, mask), kwargs)
        d = pred.float() - target
        return (d * d).sum()

    def train_step(self, batch: Batch, *, plain: bool = False) -> float:
        """One Adam step on a batch; returns its summed squared error."""
        seeds = self.seed_fn(self.steps, batch.mask.shape[1])
        loss = self.batch_loss(batch, seeds, plain=plain)
        (loss / float(sum(batch.lengths))).backward()
        for group in self.optimizer.param_groups:
            group["lr"] = self.scheduler.lr
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.steps += 1
        return float(loss.detach())

    def train_epoch(self, data: Dict[str, np.ndarray], target: np.ndarray,
                    seq_lens: List[int], *, batch_size: int = 25,
                    rng: Optional[np.random.RandomState] = None,
                    pad_time_to: Optional[int] = None) -> float:
        """One epoch over shuffled reference batches.  Returns the mean loss
        per timepoint (the reference's epoch loss)."""
        self._epoch += 1
        loss_sum, data_num = 0.0, 0
        batches = make_batches(data, target, seq_lens, batch_size=batch_size,
                               shuffle=True, rng=rng, pad_time_to=pad_time_to)
        for batch_num, batch in enumerate(batches):
            loss_sum += self.train_step(batch)
            data_num += sum(batch.lengths)
            if self.logger:
                self.logger.info('Batch: {:5d}\tLoss: {:2.5f}'.format(
                    batch_num, loss_sum / data_num))
        epoch_loss = loss_sum / max(data_num, 1)
        if self.logger:
            self.logger.info('---')
            self.logger.info('Epoch: {}\tLoss: {:2.5f}'.format(
                self._epoch, epoch_loss))
        return epoch_loss

    def scheduler_step(self, metric: float) -> float:
        """Feed the plateau controller an evaluation loss; returns the
        learning rate the next steps use."""
        return self.scheduler.step(metric)
