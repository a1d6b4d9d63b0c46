"""CNN + Highway front end, one per modality.

Counterpart of `multimodal_transformer_tpu/models/frontend.py`: every
[B, W, F, D] window tensor goes through Conv1d(k=2) + max over the frames
(computed as one pair-concat matmul) and a Highway gate, then, in training,
hash dropout (p = 0.3) over the flat [B, W, E] positions.  The front end is
plain PyTorch with autograd for its backward (the JAX package computes it
in XLA; its window-embed kernel is off by default).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.basic import Highway, conv1d_window_embed, dropout
from ..utils.init import init_conv1d

DROPOUT = 0.3


class CNN(nn.Module):
    def __init__(self, in_dim: int, embed: int, k: int = 2,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.conv1d = nn.Conv1d(in_dim, embed, k)
        if gen is not None:
            init_conv1d(self.conv1d, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv1d_window_embed(x, self.conv1d.weight, self.conv1d.bias)


def add_frontend(module: nn.Module, mods, dims, window_embed_size,
                 gen: torch.Generator | None = None) -> None:
    """Registers cnn_<mod> and highway_<mod> on module, in the JAX
    package's parameter names."""
    for m in mods:
        e = window_embed_size[m]
        setattr(module, f"cnn_{m}", CNN(dims[m], e, gen=gen))
        setattr(module, f"highway_{m}", Highway(e, gen))


def frontend_apply(module: nn.Module, inputs, mods, seeds=None) -> dict:
    """inputs: mod -> [B, W, F, D]; seeds: mod -> dropout seed in training,
    None in eval.  Returns mod -> [B, W, E_mod]."""
    return {m: dropout(getattr(module, f"highway_{m}")(
                getattr(module, f"cnn_{m}")(inputs[m])),
                None if seeds is None else seeds[m], DROPOUT) for m in mods}
