"""The reference's LayerNorm, with both of its quirks.

Counterpart of `multimodal_transformer_tpu/ops/norm.py`: the standard
deviation is the unbiased one (divided by D - 1), and eps (1e-6) is added to
the standard deviation, not to the variance.
"""

from __future__ import annotations

import torch
from torch import nn


def layer_norm(x: torch.Tensor, a_2: torch.Tensor, b_2: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    d = x - mean
    var = (d * d).sum(dim=-1, keepdim=True) / (x.shape[-1] - 1)
    return a_2 * d / (torch.sqrt(var) + eps) + b_2


class LayerNorm(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.a_2 = nn.Parameter(torch.ones(features))
        self.b_2 = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.a_2, self.b_2)
