"""Rank programs of tests/test_torch_parallel.py, run by
`multimodal_transformer_tpu_torch.parallel.spawn` on gloo over the CPU.

This module imports torch and the port only, never jax: the ranks are fresh
processes, and the JAX side (with the dropout seeds each step draws) is
computed by the test in its own process and passed in as plain values.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from multimodal_transformer_tpu_torch import build_model, default_config
from multimodal_transformer_tpu_torch.data import Batch
from multimodal_transformer_tpu_torch.engine import Engine
from multimodal_transformer_tpu_torch.ops.seeds import DropoutSeeds
from multimodal_transformer_tpu_torch.parallel import (make_mesh, make_mesh_2d,
                                                       shard_batch,
                                                       shard_params_tp)


def config(spec: dict):
    cfg = default_config(spec["family"], spec["mods"],
                         mask_mode=spec["mask_mode"])
    object.__setattr__(cfg, "mod_dimension", dict(spec["dims"]))
    return cfg


class NoShuffle:
    def shuffle(self, a):
        pass


_FOR_ROWS = DropoutSeeds.for_rows


def _unshifted(self, sites, r0, rows, T):
    """for_rows without the shift (hash seeds) or without the rows' counters
    (threefry keys): every rank draws the masks of the global batch's first
    rows."""
    return dataclasses.replace(self, rows=(r0, rows))


def _local_out(self, sites, r0, rows, T):
    """for_rows whose `out` site indexes the rank's own rows only."""
    return dataclasses.replace(_FOR_ROWS(self, sites, r0, rows, T), rows=None)


CONTROLS = {None: _FOR_ROWS, "unshifted": _unshifted, "local_out": _local_out}


def _run_case(mesh, case: dict) -> dict:
    """case["control"] names a negative control's broken for_rows."""
    cfg = config(case)
    seeds = case["seeds"]
    eng = Engine(cfg, lr=1e-3, seed=case["seed"], device="cpu",
                 nan_guard=False, mesh=mesh, dropout_impl=case["impl"],
                 prng_impl=case["prng"], seed_fn=lambda step, T: seeds[step])
    out = {}
    DropoutSeeds.for_rows = CONTROLS[case.get("control")]
    try:
        if case["kind"] == "resident":
            store = eng.upload_dataset(case["x"], case["y"], case["lens"])
            out["loss"] = eng.train_epoch_resident(
                store, batch_size=case["batch_size"], rng=NoShuffle())
        else:
            out["loss"] = eng.train_epoch(
                case["x"], case["y"], case["lens"],
                batch_size=case["batch_size"],
                rng=np.random.RandomState(case["shuffle_seed"]),
                pad_time_to=case.get("pad_time_to"))
    finally:
        DropoutSeeds.for_rows = _FOR_ROWS
    out["params"] = {k: v.detach().clone()
                     for k, v in eng.module.state_dict().items()}
    if case.get("evaluate"):
        cccs, _, _, loss, _, _ = eng.evaluate_per_video(case["x"], case["y"],
                                                        case["lens"])
        out["per_video"] = (cccs, loss)
        cccs, loss, _ = eng.evaluate_batched(case["x"], case["y"],
                                             case["lens"], batch_size=4,
                                             time_multiple=4)
        out["batched"] = (cccs, loss)
    return out


def dp_cases(rank: int, cases: dict) -> dict:
    """Each case on a 1-D "data" mesh over every rank."""
    torch.set_num_threads(1)
    mesh = make_mesh(device_type="cpu")
    return {name: _run_case(mesh, case) for name, case in cases.items()}


def tp_cases(rank: int, cases: dict, n_data: int, n_model: int) -> dict:
    """Each case's eval forward on an n_data x n_model mesh: this rank's
    rows of the batch through its shards of the encoders.  Returns the
    rows' predictions and the rank's parameter shards."""
    torch.set_num_threads(1)
    mesh = make_mesh_2d(n_data, n_model, device_type="cpu")
    out = {}
    for name, case in cases.items():
        cfg = config(case)
        module = build_model(cfg, seed=case["seed"])
        module.eval()
        tp_module, layout = shard_params_tp(module, mesh)
        x, mask = case["x"], case["mask"]
        batch = shard_batch(Batch(x, mask, mask, [0] * mask.shape[0]),
                            mesh["data"])
        with torch.inference_mode():
            pred = tp_module({m: torch.from_numpy(v)
                              for m, v in batch.data.items()},
                             torch.from_numpy(batch.mask))
        out[name] = {"r0": batch.r0, "pred": pred.clone(), "layout": layout,
                     "params": {k: v.detach().clone()
                                for k, v in tp_module.state_dict().items()}}
    return out
