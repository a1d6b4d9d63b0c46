"""Data and tensor parallelism of the PyTorch port over torch.distributed
(counterpart of `multimodal_transformer_tpu/parallel/`)."""

from .mesh import Shard, make_mesh, pad_batch_rows, shard_batch, spawn
from .tp import make_mesh_2d, shard_params_tp, tp_param_shardings

__all__ = ["Shard", "make_mesh", "make_mesh_2d", "pad_batch_rows",
           "shard_batch", "shard_params_tp", "spawn", "tp_param_shardings"]
