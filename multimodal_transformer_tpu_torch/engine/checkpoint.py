"""Checkpoints: the reference's `.pth` models, the port's train states, and
the JAX package's msgpack files.

Counterpart of `multimodal_transformer_tpu/engine/checkpoint.py`.

  * Model checkpoints are `.pth` files as the reference writes them
    (reference MFT/train.py:345-351): `{modalities, mod_dimension,
    window_size, model}`, `model` in the reference's key layout
    (engine/convert.py), so the JAX CLI (`train.py --eval --load X.pth`)
    and the reference read them.
  * Train states (`Engine.save_state`) are `torch.save` dicts: the port's
    state_dict, the Adam state_dict, the scheduler, the epoch and step, the
    best CCC and the configuration (the dropout keys follow from the
    epoch).
  * The JAX package's `.ckpt` (`save_checkpoint`) and `.state`
    (`save_train_state`) files are read with engine/flax_msgpack.py; their
    parameter trees flattened with "." are the port's state_dict keys.

Every write goes to a temporary file first and then replaces the target, so
a preemption mid-write leaves the previous file whole.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from ..models.config import ModelConfig
from ..utils.params import flatten_tree
from . import flax_msgpack
from .convert import convert_pth, detect_config, export_state_dict

TRAIN_STATE_FORMAT = "multimodal_transformer_tpu_torch train state"


def atomic_save(obj, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(cfg: ModelConfig, state: Dict, path: str) -> None:
    """Write the port's state_dict as a reference-layout `.pth`."""
    model = {k: torch.from_numpy(v)
             for k, v in export_state_dict(cfg, state).items()}
    atomic_save({"modalities": list(cfg.modalities),
                 "mod_dimension": dict(cfg.mod_dimension),
                 "window_size": dict(cfg.window_size),
                 "model": model}, path)


def is_msgpack(path: str) -> bool:
    """torch.save writes a zip archive; the JAX package writes msgpack."""
    with open(path, "rb") as f:
        return f.read(4) != b"PK\x03\x04"


def load_model(path: str, family: str,
               mask_mode: str = "query") -> Tuple[ModelConfig, Dict]:
    """A model checkpoint, `.pth` (reference layout) or the JAX package's
    msgpack `.ckpt`, -> (cfg, the port's state_dict as numpy arrays).  The
    configuration comes from the file's metadata and weights
    (convert.detect_config)."""
    if not is_msgpack(path):
        return convert_pth(path, family, mask_mode=mask_mode)
    ck = flax_msgpack.load(path)
    state = {k: np.asarray(v, np.float32)
             for k, v in flatten_tree(ck["model"]).items()}
    return detect_config(family, ck, state, mask_mode=mask_mode), state


def load_train_state(path: str) -> Dict:
    """A train state, the port's (its dict) or the JAX package's msgpack
    `.state` (its decoded tree: model, opt_state, epoch, scheduler,
    best_ccc and the configuration)."""
    if is_msgpack(path):
        return flax_msgpack.load(path)
    st = torch.load(path, map_location="cpu", weights_only=True)
    if st.get("format") != TRAIN_STATE_FORMAT:
        raise ValueError(f"{path} is not a train state of this package")
    return st


def jax_leaf_order(names):
    """The order in which the JAX package flattens a parameter tree (dict
    keys sorted, list entries by index), given the flattened names."""
    return sorted(names, key=lambda n: [int(c) if c.isdigit() else c
                                        for c in n.split(".")])


def adam_state_from_jax(opt_state: Dict, shapes: Dict[str, tuple]
                        ) -> Dict[int, Dict[str, torch.Tensor]]:
    """The JAX Adam state {"step", "m", "v"} (engine/optim.py; m and v param
    trees, or flat vectors in the JAX flattening order under
    MMTX_FLAT_ADAM) -> torch.optim.Adam's per-parameter state, indexed in
    the order of `shapes` (the module's named_parameters)."""
    m, v = opt_state["m"], opt_state["v"]
    if isinstance(m, np.ndarray) and m.ndim == 1:
        order = jax_leaf_order(shapes)
        offsets = np.cumsum([0] + [int(np.prod(shapes[n])) for n in order])
        split = lambda flat: {n: flat[offsets[i]:offsets[i + 1]]
                              for i, n in enumerate(order)}
        m, v = split(m), split(v)
    else:
        m, v = flatten_tree(m), flatten_tree(v)
    step = torch.tensor(float(np.asarray(opt_state["step"])))
    return {i: {"step": step.clone(),
                "exp_avg": torch.from_numpy(
                    np.array(m[n], np.float32).reshape(shape)),
                "exp_avg_sq": torch.from_numpy(
                    np.array(v[n], np.float32).reshape(shape))}
            for i, (n, shape) in enumerate(shapes.items())}
