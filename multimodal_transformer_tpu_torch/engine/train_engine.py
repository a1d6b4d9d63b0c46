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

Every family trains (the JAX `build_model`'s configurations), from the
JAX Engine's initial weights for the same seed (`build_model(cfg,
seed=seed)`, drawn on the engine's device).  Every step takes the JAX
Engine's dropout: the key fold_in(PRNGKey(epoch), batch), with batch
counted from 0 in each epoch (`step_seeds`), split along the configuration's
key tree (`DropoutSeeds.from_key` over `dropout_sites()`), hashed into
seeds on the "hash" stream (the default; kernels 3-7 and 10 draw their
masks) and the "hash4" stream (`dropout_impl="hash4"`, the JAX package's
MMTX_DROPOUT_IMPL=hash4: kernels 3, 4 and 5 draw its multi-bit masks, the
MFN kernels its per-element gamma bits), or kept as keys on the
"threefry" stream (`dropout_impl="threefry"`: kernel T draws every mask,
and the encoders and the MFN run their plain paths on the card, as the
JAX package routes that stream off its kernels).  `prng_impl="rbg"` takes
the JAX package's rbg keys (`jax_default_prng_impl="rbg"`, its CLI's
--fast_rng) for the weights and the step keys; kernel P then draws what
kernel T draws.  `seed_fn(step, T)` -> DropoutSeeds, where given, replaces
that derivation (step counts the engine's steps from 0, T is the batch's
length).  `encoder_backward`
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

Data parallelism (`mesh=`, a 1-D "data" mesh of parallel/mesh.py; one
process per rank, the JAX package's `Engine(mesh=...)`): every rank builds
the same global batches from the same host RNG and keeps its own rows
(`shard_batch`, before the prefetcher stages them), with its dropout seeds
shifted to those rows (`DropoutSeeds.for_rows`: hash seeds shifted,
threefry keys drawing the rows' range of counters), so its masks are the
padded global batch's, as GSPMD computes them in the JAX package.  A rank's loss is
its rows' squared error over the global batch's sum of lengths; after the
backward one all_reduce of a flat buffer sums the gradients and the losses,
then each rank runs Adam, so the parameters stay equal (they start equal:
the same seed, then a broadcast from rank 0, also after `restore_state`).
No DDP wrapper: `_predict` runs `functional_call` on cast copies, which
DDP's hooks would not see.  The resident store is replicated on every rank
(the JAX package shards it); each rank gathers its rows.  The evaluations
split the videos (per video) or each bucket's rows (batched) over the ranks
and gather, so every rank returns the one-device results in the one-device
order.  Only rank 0 logs and writes state files.
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
from ..ops.seeds import DROPOUT_IMPLS, DropoutSeeds
from ..parallel import mesh as dp
from ..utils import prng
from ..utils.params import flatten_tree
from . import checkpoint
from .guards import NanGuard
from .optim import ReduceLROnPlateau, make_adam


class Engine:
    """Trains one (family, modalities) configuration on one device (the
    card unless the caller names another), or data-parallel over a mesh
    with one device per rank."""

    def __init__(self, cfg: ModelConfig, lr: float = 1e-4,
                 weight_decay: float = 1e-4, seed: int = 1,
                 train_dtype: Optional[torch.dtype] = None,
                 device: torch.device | str = "cuda", *, logger=None,
                 seed_fn: Optional[Callable[[int, int], DropoutSeeds]] = None,
                 eval_dtype: Optional[torch.dtype] = None,
                 encoder_backward: str = "perlayer", nan_guard: bool = True,
                 mesh=None, dropout_impl: str = "hash",
                 prng_impl: str = "threefry"):
        """train_dtype: bf16 mixed training when set; eval_dtype: the dtype
        of `evaluate_batched`'s forward (None: float32), as in the JAX
        Engine, whose per-video evaluation stays float32; encoder_backward:
        "perlayer" or "stack" (anything else raises); nan_guard: check
        losses and parameters for NaN and infinity (NanGuard); mesh: a 1-D
        "data" DeviceMesh (parallel.make_mesh) for data parallelism, this
        process being one of its ranks, device its device; dropout_impl:
        "hash", "hash4" or "threefry"; prng_impl: the key implementation
        of the initial weights and the step keys, "threefry" (JAX's
        default) or "rbg" (JAX's under `jax_default_prng_impl="rbg"`,
        the JAX CLI's --fast_rng)."""
        self.cfg = cfg
        self.encoder_backward = check_encoder_backward(encoder_backward)
        if dropout_impl not in DROPOUT_IMPLS:
            raise ValueError(f"dropout_impl must be one of {DROPOUT_IMPLS}, "
                             f"got {dropout_impl!r}")
        self.dropout_impl = dropout_impl
        if prng_impl not in prng.IMPLS:
            raise ValueError(f"prng_impl must be one of {prng.IMPLS}, got "
                             f"{prng_impl!r}")
        self.prng_impl = prng_impl
        self.device = torch.device(device)
        self.logger = logger
        self.train_dtype = train_dtype
        self.eval_dtype = eval_dtype
        self.module = build_model(cfg, seed=seed, device=self.device,
                                  prng_impl=prng_impl)
        self.module.train()
        self.optimizer = make_adam(self.module.parameters(), lr, weight_decay)
        self.scheduler = ReduceLROnPlateau(lr=lr)
        self.seed_fn = seed_fn
        self.nan_guard = NanGuard() if nan_guard else None
        self.steps = 0
        self._epoch = 0
        self._batch = 0  # train steps in this epoch: the key's fold_in
        self.mesh = mesh
        self.rank = 0 if mesh is None else mesh.get_local_rank()
        if mesh is not None:
            dp.broadcast_flat(self.module.parameters(), mesh)
            self._grad_buffer = dp.FlatBuffer()

    def step_seeds(self, T: int) -> DropoutSeeds:
        """The next step's dropout seeds: `seed_fn` where given, else those
        of the JAX Engine's key of the step, fold_in(PRNGKey(epoch),
        batch) under the engine's key implementation, on its stream."""
        if self.seed_fn is not None:
            return self.seed_fn(self.steps, T)
        key = prng.fold_in(prng.key(self._epoch, self.prng_impl),
                           self._batch)
        return DropoutSeeds.from_key(self.module.dropout_sites(), key, T,
                                     self.dropout_impl)

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
        """One Adam step on a batch; returns its summed squared error.
        With a mesh, batch is the global batch (cut to this rank's rows
        here) or this rank's Shard of it, and the result is the global
        batch's summed squared error on every rank."""
        if self.mesh is not None and not isinstance(batch, dp.Shard):
            batch = dp.shard_batch(batch, self.mesh)
        T = batch.mask.shape[1]
        seeds = self.step_seeds(T)
        if isinstance(batch, dp.Shard):
            seeds = seeds.for_rows(self.module.dropout_sites(), batch.r0,
                                   batch.rows, T)
        loss = self.batch_loss(batch, seeds, plain=plain)
        (loss / float(_total(batch))).backward()
        loss = loss.detach()
        if self.mesh is not None:
            # the gradients and the loss summed over the ranks, one buffer
            grads = [p.grad for p in self.module.parameters()
                     if p.grad is not None]
            loss = loss.reshape(1)
            dp.all_reduce_flat(grads + [loss], self.mesh, self._grad_buffer)
        for group in self.optimizer.param_groups:
            group["lr"] = self.scheduler.lr
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.steps += 1
        self._batch += 1
        return float(loss)

    def _after_step(self, batch_num: int, loss: float, loss_sum: float,
                   data_num: int) -> None:
        if self.nan_guard:
            self.nan_guard.check(loss, self.module.named_parameters())
        if self.logger and self.rank == 0:
            self.logger.info('Batch: {:5d}\tLoss: {:2.5f}'.format(
                batch_num, loss_sum / data_num))

    def _log_epoch(self, loss_sum: float, data_num: int) -> float:
        epoch_loss = loss_sum / max(data_num, 1)
        if self.logger and self.rank == 0:
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
        self._batch = 0
        loss_sum, data_num = 0.0, 0
        batches = make_batches(data, target, seq_lens, batch_size=batch_size,
                               shuffle=True, rng=rng, pad_time_to=pad_time_to)
        if self.mesh is not None:  # each rank stages only its own rows
            batches = (dp.shard_batch(b, self.mesh) for b in batches)
        if prefetch:
            batches = DevicePrefetcher(batches, self.device, depth=prefetch)
        for batch_num, batch in enumerate(batches):
            loss = self.train_step(batch)
            loss_sum += loss
            data_num += _total(batch)
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
        mask zeroed, so they add nothing to the loss or the gradients.
        With a mesh each rank gathers only its rows of that batch (padded
        to a multiple of the mesh size the same way)."""
        self._epoch += 1
        self._batch = 0
        n = len(store["lengths"])  # real videos only
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
            r0, local, rows = 0, batch_size, batch_size
            if self.mesh is not None:
                r0, local, rows = dp.shard_rows(batch_size, self.mesh)
            chunk = np.resize(chunk, rows)[r0:r0 + local]
            idx = torch.from_numpy(chunk).to(self.device)
            valid = (torch.arange(r0, r0 + local, device=self.device)
                     < real).float()[:, None, None]
            parts = ({m: v.index_select(0, idx)
                      for m, v in store["data"].items()},
                     store["target"].index_select(0, idx) * valid,
                     store["mask"].index_select(0, idx) * valid,
                     lens[r0:r0 + local],
                     [int(c) for c in chunk[:max(real - r0, 0)]])
            batch = (Batch(*parts) if self.mesh is None else
                     dp.Shard(*parts, r0=r0, rows=rows, total=sum(lens)))
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
        # with a mesh, rank r predicts videos r, r + n, ...; all gather
        n = 1 if self.mesh is None else self.mesh.size()
        targets, outs = [], {}
        for i, batch in enumerate(batches):
            targets.append((batch.target, batch.lengths))
            if i % n == self.rank:
                outs[i] = self._predict(batch, None).cpu().numpy()
        if self.mesh is not None:
            for part in dp.gather_objects(outs, self.mesh):
                outs.update(part)
        for index, (tgt, lengths) in enumerate(targets, 1):
            out = outs[index - 1]
            d = out - tgt
            loss_sum += float((d * d).sum())
            data_num += sum(lengths)
            o = out.reshape(-1)
            t = tgt.reshape(-1)
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
        if self.logger and self.rank == 0:
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
        video order, loss, stats).  With a mesh each rank runs its rows of
        every bucket batch, and the results are gathered."""
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
            if self.mesh is not None:
                batch = dp.shard_batch(batch, self.mesh)
            pred = self._predict(batch, self.eval_dtype)
            tgt = self._tensor(batch.target)
            loss_sum += float(masked_mse_sum(pred, tgt))
            data_num += sum(batch.lengths)
            c = ccc_masked(tgt[..., 0], pred[..., 0],
                           self._tensor(batch.mask)[..., 0])
            # buckets reorder the videos; put each CCC back at its index
            cccs[batch.indices] = c[:len(batch.lengths)].cpu().numpy()
        if self.mesh is not None:  # each video's CCC comes from one rank
            parts = dp.gather_objects((cccs, loss_sum, data_num), self.mesh)
            cccs = np.sum([p[0] for p in parts], axis=0)
            loss_sum = sum(p[1] for p in parts)
            data_num = sum(p[2] for p in parts)
        cccs = cccs.tolist()
        stats = {"ccc": float(np.mean(cccs)), "ccc_std": float(np.std(cccs)),
                 "max_ccc": float(np.max(cccs))}
        return cccs, loss_sum / max(data_num, 1), stats

    def scheduler_step(self, metric: float) -> float:
        """Feed the plateau controller an evaluation loss; returns the
        learning rate the next steps use (with a mesh, rank 0's metric on
        every rank)."""
        if self.mesh is not None:
            metric = dp.gather_objects(metric, self.mesh)[0]
        return self.scheduler.step(metric)

    def save_state(self, path: str, best_ccc: float = -1.0) -> None:
        """Write the whole training state (parameters, Adam state,
        scheduler, epoch and step, best CCC and the configuration)
        atomically, for `restore_state` (the dropout keys follow from the
        epoch).  With a
        mesh, rank 0 writes and every rank waits for it."""
        if self.rank == 0:
            self._write_state(path, best_ccc)
        if self.mesh is not None:
            dp.barrier(self.mesh)

    def _write_state(self, path: str, best_ccc: float) -> None:
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
            "best_ccc": float(best_ccc)}, path)

    def restore_state(self, path: str) -> float:
        """Restore a `save_state` file, or the JAX package's msgpack
        `.state` (its Adam moments mapped onto torch's Adam state, the step
        count from its Adam step).  Both packages draw the dropout keys
        from the epoch, so a resumed run continues the same stream.  Returns the
        recorded best CCC.  With a mesh every rank reads the file, and the
        parameters are broadcast from rank 0."""
        st = checkpoint.load_train_state(path)
        if "format" in st:
            self.module.load_state_dict(st["model"])
            self.optimizer.load_state_dict(st["optimizer"])
            self.steps = int(st["steps"])
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
        if self.mesh is not None:
            dp.broadcast_flat(self.module.parameters(), self.mesh)
        return float(st["best_ccc"])


def _total(batch: Batch) -> int:
    """The global batch's sum of lengths: the loss's denominator."""
    return batch.total if isinstance(batch, dp.Shard) else sum(batch.lengths)
