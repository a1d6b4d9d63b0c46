"""Tensor-parallel layout of the encoders over a 2-D ("data", "model") mesh.

Counterpart of `multimodal_transformer_tpu/parallel/tp.py`, the same
Megatron layout per encoder layer:
  * q, k, v projections: weight and bias split on the output (head) axis,
    so each "model" rank computes h / n_model heads;
  * out projection: weight split on its input axis, bias replicated (added
    after the all_reduce);
  * FFN w_1: weight and bias split on the output (d_ff) axis; w_2: weight
    split on its input axis, bias replicated;
  * everything else (norms, embeds, heads, the MFN) replicated.

Torch-layout weights are [out, in], so "output split" is axis 0.  The JAX
package annotates shardings and lets GSPMD insert the collectives; here each
rank slices its shards from the full parameters it builds or loads
(`shard_params_tp`, no scatter), and the encoder of the copy runs its
layers with one all_reduce after the out projection and one after w_2
(ops/attention.py).  Eval only: `shard_params_tp` refuses a head count or
d_ff that the "model" size does not divide, where GSPMD would pad.  The
batch's rows go over "data" with `mesh.shard_batch(batch, mesh["data"])`.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..models.heads import HEADS
from ..ops.attention import Encoder


def make_mesh_2d(n_data: int, n_model: int,
                 device_type: str = "cuda") -> DeviceMesh:
    """A ("data", "model") mesh of n_data x n_model ranks of the initialised
    process group; raises without a card for device_type "cuda"."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh_2d(device_type='cuda'): no CUDA device")
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=("data", "model"))


def tp_param_shardings(module: nn.Module) -> Dict[str, Optional[int]]:
    """name -> the axis split over "model" (0 output, 1 input), or None for
    a replicated parameter: the JAX `tp_param_shardings` layout by name."""
    def axis(name: str, ndim: int) -> Optional[int]:
        keys = name.split(".")
        if "layers" not in keys:
            return None
        if "self_attn" in keys and "linears" in keys:
            qkv = int(keys[keys.index("linears") + 1]) in (0, 1, 2)
            if ndim == 2:
                return 0 if qkv else 1
            return 0 if qkv else None
        if "w_1" in keys:
            return 0
        if "w_2" in keys and ndim == 2:
            return 1
        return None

    return {name: axis(name, p.ndim) for name, p in module.named_parameters()}


def shard_params_tp(module: nn.Module,
                    mesh: DeviceMesh) -> Tuple[nn.Module, Dict]:
    """(a copy of module holding this rank's shards, the layout): every
    split parameter cut to this "model" rank's block, every encoder given
    the "model" group.  Raises when the "model" size does not divide the
    heads or an encoder's d_ff."""
    n = mesh["model"].size()
    rank = mesh["model"].get_local_rank()
    layout = tp_param_shardings(module)
    for enc in (m for m in module.modules() if isinstance(m, Encoder)):
        d_ff = enc.layers[0].feed_forward.w_1.out_features
        if HEADS % n or d_ff % n:
            raise ValueError(f"tensor parallelism over {n} ranks needs the "
                             f"heads ({HEADS}) and d_ff ({d_ff}) divisible "
                             f"by {n}")
    shard = copy.deepcopy(module)
    for name, ax in layout.items():
        if ax is None:
            continue
        owner, _, leaf = name.rpartition(".")
        sub = shard.get_submodule(owner)
        full = getattr(sub, leaf)
        setattr(sub, leaf, nn.Parameter(
            full.detach().chunk(n, dim=ax)[rank].clone(),
            requires_grad=full.requires_grad))
    for lin in (m for m in shard.modules() if isinstance(m, nn.Linear)):
        lin.out_features, lin.in_features = lin.weight.shape
    for enc in (m for m in shard.modules() if isinstance(m, Encoder)):
        enc.tp_group = mesh.get_group("model")
        enc.tp_size = n
    return shard, layout
