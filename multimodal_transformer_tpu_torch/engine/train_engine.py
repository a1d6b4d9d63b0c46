"""Train/eval engine: one Adam step per batch, epoch loops, per-video CCC
evaluation, reference logs.

Counterpart of `multimodal_transformer_tpu/engine/train_engine.py` `Engine`
(reference MFT/train.py:110-257):
  * loss = MSE(sum) over the masked batch, divided by sum(lengths) for the
    gradient step;
  * one Adam step per batch with the scheduler's current learning rate;
  * `evaluate_per_video`: the reference's evaluation, one video at a time
    at its own length, CCC and Pearson r per video on the host, in float32;
  * `evaluate_batched`: fixed-shape length buckets with the per-video CCC
    computed on the device, in `eval_dtype` when one is set (exact only in
    "key_query" mode, which it requires);
  * `Batch:` / `Epoch:` / `Evaluation` log lines byte-identical to the
    reference's.

Mixed precision (train_dtype=torch.bfloat16) casts the float32 master
parameters and the inputs to bf16 INSIDE the autograd graph, so the
gradients flow back through the casts and arrive in float32 at the masters;
the loss is summed in float32.

Every family trains (the JAX `build_model`'s configurations).  Every step
draws its dropout seeds with `seed_fn(step, T)` -> DropoutSeeds
(ops/seeds.py), where step counts the engine's steps from 0 and T is the
batch's length; the default draws the sites of the configuration's module
(`dropout_sites()`) from the engine's torch.Generator.  `encoder_backward`
picks the encoders' training backward on the card: "perlayer" (kernel 4 per
layer, the JAX package's default) or "stack" (kernel 5 per stack, the JAX
package's opt-in MMTX_ENC_BWD=stack); both give the same bits.
Evaluation runs without seeds (eval mode) under `torch.inference_mode()`;
videos longer than 512 windows take the encoders' flash route (kernel 11),
shorter ones kernel A.

`train_epoch` builds its batches on a host thread that stages them on the
device `prefetch` batches ahead (data/prefetch.py).  `upload_dataset` keeps
a split on the device and `train_epoch_resident` gathers each batch there
with `index_select`, at the split's full length (exact only in "key_query"
mode).  A NanGuard (engine/guards.py) checks every step's loss and the
parameters every 50 steps.  `save_state` / `restore_state` write and read
the whole training state (engine/checkpoint.py), and `restore_state` also
reads the JAX package's msgpack `.state` files.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from ..data.batching import (Batch, bucketed_eval_batches, len_to_mask,
                             make_batches)
from ..data.prefetch import DevicePrefetcher
from ..models import ModelConfig, build_model
from ..ops.dispatch import check_encoder_backward
from ..ops.metrics import ccc, ccc_masked, masked_mse_sum, pearson
from ..ops.seeds import DropoutSeeds
from ..utils.params import flatten_tree
from . import checkpoint
from .guards import NanGuard
from .optim import ReduceLROnPlateau, make_adam


class Engine:
    """Trains one (family, modalities) configuration on one device (the
    card unless the caller names another)."""

    def __init__(self, cfg: ModelConfig, lr: float = 1e-4,
                 weight_decay: float = 1e-4, seed: int = 1,
                 train_dtype: Optional[torch.dtype] = None,
                 device: torch.device | str = "cuda", *, logger=None,
                 seed_fn: Optional[Callable[[int, int], DropoutSeeds]] = None,
                 eval_dtype: Optional[torch.dtype] = None,
                 encoder_backward: str = "perlayer", nan_guard: bool = True):
        """train_dtype: bf16 mixed training when set; eval_dtype: the dtype
        of `evaluate_batched`'s forward (None: float32), as in the JAX
        Engine, whose per-video evaluation stays float32; encoder_backward:
        "perlayer" or "stack" (anything else raises); nan_guard: check
        losses and parameters for NaN and infinity (NanGuard)."""
        self.cfg = cfg
        self.encoder_backward = check_encoder_backward(encoder_backward)
        self.device = torch.device(device)
        self.logger = logger
        self.train_dtype = train_dtype
        self.eval_dtype = eval_dtype
        self.module = build_model(
            cfg, generator=torch.Generator().manual_seed(seed)).to(self.device)
        self.module.train()
        self.optimizer = make_adam(self.module.parameters(), lr, weight_decay)
        self.scheduler = ReduceLROnPlateau(lr=lr)
        self.generator = torch.Generator().manual_seed(seed)
        self.seed_fn = seed_fn or self._draw_seeds
        self.nan_guard = NanGuard() if nan_guard else None
        self.steps = 0
        self._epoch = 0

    def _draw_seeds(self, step: int, T: int) -> DropoutSeeds:
        return DropoutSeeds.draw(self.module.dropout_sites(), T,
                                 self.generator)

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(device=self.device, dtype=dtype or torch.float32)

    def _predict(self, batch: Batch, dtype: Optional[torch.dtype],
                 **kwargs) -> torch.Tensor:
        """The module's float32 predictions [B, T, 1] for a batch, with the
        parameters and inputs cast to dtype inside the graph (None: the
        float32 masters as they are)."""
        data = {m: self._tensor(v, dtype) for m, v in batch.data.items()}
        mask = self._tensor(batch.mask, dtype)
        if dtype is None:
            return self.module(data, mask, **kwargs).float()
        params = {k: v.to(dtype) for k, v in self.module.named_parameters()}
        return functional_call(self.module, params, (data, mask),
                               kwargs).float()

    def batch_loss(self, batch: Batch, seeds: DropoutSeeds, *,
                   plain: bool = False) -> torch.Tensor:
        """Sum of squared errors of one batch (float32, differentiable in
        the module's parameters).  The batch's arrays may be numpy arrays
        or tensors already on the device."""
        pred = self._predict(batch, self.train_dtype, seeds=seeds, plain=plain,
                             encoder_backward=self.encoder_backward)
        return masked_mse_sum(pred, self._tensor(batch.target))

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

    def _after_step(self, batch_num: int, loss: float, loss_sum: float,
                   data_num: int) -> None:
        if self.nan_guard:
            self.nan_guard.check(loss, self.module.named_parameters())
        if self.logger:
            self.logger.info('Batch: {:5d}\tLoss: {:2.5f}'.format(
                batch_num, loss_sum / data_num))

    def _log_epoch(self, loss_sum: float, data_num: int) -> float:
        epoch_loss = loss_sum / max(data_num, 1)
        if self.logger:
            self.logger.info('---')
            self.logger.info('Epoch: {}\tLoss: {:2.5f}'.format(
                self._epoch, epoch_loss))
        return epoch_loss

    def train_epoch(self, data: Dict[str, np.ndarray], target: np.ndarray,
                    seq_lens: List[int], *, batch_size: int = 25,
                    rng: Optional[np.random.RandomState] = None,
                    pad_time_to: Optional[int] = None,
                    prefetch: int = 2) -> float:
        """One epoch over shuffled reference batches.  Returns the mean loss
        per timepoint (the reference's epoch loss).  prefetch: batches a
        host thread stages on the device ahead of the step (0: none, the
        batches are built in the loop)."""
        self._epoch += 1
        loss_sum, data_num = 0.0, 0
        batches = make_batches(data, target, seq_lens, batch_size=batch_size,
                               shuffle=True, rng=rng, pad_time_to=pad_time_to)
        if prefetch:
            batches = DevicePrefetcher(batches, self.device, depth=prefetch)
        for batch_num, batch in enumerate(batches):
            loss = self.train_step(batch)
            loss_sum += loss
            data_num += sum(batch.lengths)
            self._after_step(batch_num, loss, loss_sum, data_num)
        return self._log_epoch(loss_sum, data_num)

    def upload_dataset(self, data: Dict[str, np.ndarray], target: np.ndarray,
                       seq_lens: List[int]) -> dict:
        """Put a whole padded split on the device once: the handle that
        `train_epoch_resident` takes."""
        mask = len_to_mask(seq_lens).astype(np.float32)
        return {"data": {m: self._tensor(v) for m, v in data.items()},
                "target": self._tensor(target[..., None]),
                "mask": self._tensor(mask),
                "lengths": np.asarray(seq_lens)}

    def train_epoch_resident(self, store: dict, *, batch_size: int = 25,
                             rng: Optional[np.random.RandomState] = None
                             ) -> float:
        """One epoch over a split on the device (`upload_dataset`): each
        batch is gathered there by index, never copied from the host.

        Batches keep the split's full length (the masks mark what is real)
        instead of the reference's cut to the batch's longest video: exact
        in "key_query" mode, where padded keys are masked.  Each batch is
        sorted by length, descending, as the reference's; the last one is
        filled to batch_size by cycling its rows, with their target and
        mask zeroed, so they add nothing to the loss or the gradients."""
        self._epoch += 1
        n = len(store["lengths"])
        index = np.arange(n)
        (rng or np.random).shuffle(index)
        loss_sum, data_num = 0.0, 0
        for batch_num, i in enumerate(range(0, n, batch_size)):
            chunk = index[i:i + batch_size]
            order = sorted(range(len(chunk)),
                           key=lambda k: -int(store["lengths"][chunk[k]]))
            chunk = chunk[order]
            real = len(chunk)
            lens = [int(x) for x in store["lengths"][chunk]]
            if real < batch_size:
                chunk = np.resize(chunk, batch_size)
            idx = torch.from_numpy(chunk).to(self.device)
            valid = (torch.arange(batch_size, device=self.device)
                     < real).float()[:, None, None]
            batch = Batch({m: v.index_select(0, idx)
                           for m, v in store["data"].items()},
                          store["target"].index_select(0, idx) * valid,
                          store["mask"].index_select(0, idx) * valid,
                          lens, [int(c) for c in chunk[:real]])
            loss = self.train_step(batch)
            loss_sum += loss
            data_num += sum(lens)
            self._after_step(batch_num, loss, loss_sum, data_num)
        return self._log_epoch(loss_sum, data_num)

    @torch.inference_mode()
    def evaluate_per_video(self, data: Dict[str, np.ndarray],
                           target: np.ndarray, seq_lens: List[int], *,
                           shuffle_rng=None) -> Tuple:
        """The reference's evaluation: one video at a time at its own
        length, float32, no padding.  Returns (cccs, predictions, actuals,
        loss, stats, (best_pred, best_actual, best_index)) as the JAX Engine
        does; loss is the summed squared error per timepoint.

        shuffle_rng (a np.random.RandomState): visit the videos in a
        shuffled order, as the reference MFT evaluate() does; the metrics do
        not depend on the order, only the best video's tie-break does."""
        cccs, corrs, preds, actuals = [], [], [], []
        loss_sum, data_num = 0.0, 0
        best = (-1.0, None, None, 0)
        batches = make_batches(data, target, seq_lens, batch_size=1,
                               shuffle=shuffle_rng is not None,
                               rng=shuffle_rng)
        for index, batch in enumerate(batches, 1):
            out = self._predict(batch, None).cpu().numpy()
            d = out - batch.target
            loss_sum += float((d * d).sum())
            data_num += sum(batch.lengths)
            o = out.reshape(-1)
            t = batch.target.reshape(-1)
            preds.append(o.tolist())
            actuals.append(t.tolist())
            cur = ccc(t, o)
            cccs.append(cur)
            corrs.append(pearson(t, o))
            if cur > best[0]:
                best = (cur, o, t, index)
        loss = loss_sum / max(data_num, 1)
        stats = {"corr": float(np.mean(corrs)),
                 "corr_std": float(np.std(corrs)),
                 "ccc": float(np.mean(cccs)), "ccc_std": float(np.std(cccs)),
                 "max_ccc": best[0]}
        if self.logger:
            self.logger.info(
                'Evaluation\tLoss: {:2.5f}\tCorr: {:0.3f}\tCCC: {:0.9f}'.format(
                    loss, stats['corr'], stats['ccc']))
        return cccs, preds, actuals, loss, stats, (best[1], best[2], best[3])

    @torch.inference_mode()
    def evaluate_batched(self, data: Dict[str, np.ndarray], target: np.ndarray,
                         seq_lens: List[int], *, batch_size: int = 32,
                         time_multiple: int = 32) -> Tuple:
        """Evaluation over fixed-shape length buckets, the per-video CCC on
        the device, the forward in `eval_dtype`.  Exact only when padded
        keys are masked, so "key_query" mode is required.  Returns (cccs in
        video order, loss, stats)."""
        if self.cfg.mask_mode != "key_query":
            raise ValueError(
                "evaluate_batched pads the time axis to bucket bounds, "
                "which is only metric-preserving with mask_mode='key_query' "
                f"(got {self.cfg.mask_mode!r}); use evaluate_per_video")
        cccs = np.zeros(target.shape[0])
        loss_sum, data_num = 0.0, 0
        for batch in bucketed_eval_batches(data, target, seq_lens,
                                           batch_size=batch_size,
                                           time_multiple=time_multiple):
            pred = self._predict(batch, self.eval_dtype)
            tgt = self._tensor(batch.target)
            loss_sum += float(masked_mse_sum(pred, tgt))
            data_num += sum(batch.lengths)
            c = ccc_masked(tgt[..., 0], pred[..., 0],
                           self._tensor(batch.mask)[..., 0])
            # buckets reorder the videos; put each CCC back at its index
            cccs[batch.indices] = c[:len(batch.lengths)].cpu().numpy()
        cccs = cccs.tolist()
        stats = {"ccc": float(np.mean(cccs)), "ccc_std": float(np.std(cccs)),
                 "max_ccc": float(np.max(cccs))}
        return cccs, loss_sum / max(data_num, 1), stats

    def scheduler_step(self, metric: float) -> float:
        """Feed the plateau controller an evaluation loss; returns the
        learning rate the next steps use."""
        return self.scheduler.step(metric)

    def save_state(self, path: str, best_ccc: float = -1.0) -> None:
        """Write the whole training state (parameters, Adam state,
        scheduler, epoch and step, best CCC, the dropout generator's state
        and the configuration) atomically, for `restore_state`."""
        cfg = self.cfg
        checkpoint.atomic_save({
            "format": checkpoint.TRAIN_STATE_FORMAT,
            "family": cfg.family, "modalities": list(cfg.modalities),
            "mod_dimension": dict(cfg.mod_dimension),
            "window_size": dict(cfg.window_size),
            "model": {k: v.detach().cpu()
                      for k, v in self.module.state_dict().items()},
            "optimizer": self.optimizer.state_dict(),
            "scheduler": {"lr": self.scheduler.lr,
                          "best": self.scheduler.best,
                          "num_bad": self.scheduler.num_bad},
            "epoch": self._epoch, "steps": self.steps,
            "best_ccc": float(best_ccc),
            "generator": self.generator.get_state()}, path)

    def restore_state(self, path: str) -> float:
        """Restore a `save_state` file, or the JAX package's msgpack
        `.state` (its Adam moments mapped onto torch's Adam state, the step
        count from its Adam step; the dropout generator stays as it is,
        since the JAX package draws its keys from the epoch).  Returns the
        recorded best CCC."""
        st = checkpoint.load_train_state(path)
        if "format" in st:
            self.module.load_state_dict(st["model"])
            self.optimizer.load_state_dict(st["optimizer"])
            self.steps = int(st["steps"])
            self.generator.set_state(st["generator"])
        else:
            with torch.no_grad():
                for k, v in flatten_tree(st["model"]).items():
                    self.module.get_parameter(k).copy_(
                        torch.from_numpy(np.asarray(v, np.float32)))
            shapes = {k: tuple(p.shape)
                      for k, p in self.module.named_parameters()}
            sd = self.optimizer.state_dict()
            sd["state"] = checkpoint.adam_state_from_jax(st["opt_state"],
                                                         shapes)
            self.optimizer.load_state_dict(sd)
            self.steps = int(np.asarray(st["opt_state"]["step"]))
        self._epoch = int(st["epoch"])
        sch = st["scheduler"]
        self.scheduler.lr = float(sch["lr"])
        self.scheduler.best = float(sch["best"])
        self.scheduler.num_bad = int(sch["num_bad"])
        return float(st["best_ccc"])
