"""Basic building blocks: linear, the windowed CNN embed and the Highway gate.

Counterparts of `multimodal_transformer_tpu/ops/basic.py` in eval mode (no
dropout).  Parameters are in torch layout, the same as the JAX package's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.init import init_linear


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor) -> torch.Tensor:
    """y = x @ W.T + b with W [out, in]."""
    return F.linear(x, weight, bias)


def conv1d_window_embed(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor) -> torch.Tensor:
    """Conv1d(D -> E, k=2) over the frames of each window, then a max over
    the conv axis.  x: [..., F, D] with F >= 2; weight [E, D, 2]; returns
    [..., E].

    Computed as one matmul over adjacent-frame pairs, [..., F-1, 2D] @
    [2D, E], like the JAX package: `F.conv1d` would go through cuDNN, which
    runs float32 convolutions in TF32 by default."""
    pairs = torch.cat([x[..., :-1, :], x[..., 1:, :]], dim=-1)
    kernel = torch.cat([weight[:, :, 0], weight[:, :, 1]], dim=-1)  # [E, 2D]
    return F.linear(pairs, kernel, bias).amax(dim=-2)


def highway(hw: "Highway", x: torch.Tensor,
            relu_proj: bool = False) -> torch.Tensor:
    """g * proj(x) + (1 - g) * x with g = sigmoid(gate(x)).  relu_proj=True
    is the B1-LSTM variant (ReLU on the projection)."""
    proj = hw.linear_projection(x)
    if relu_proj:
        proj = torch.relu(proj)
    gate = torch.sigmoid(hw.linear_gate(x))
    return gate * proj + (1.0 - gate) * x


class Highway(nn.Module):
    def __init__(self, size: int, gen: torch.Generator | None = None):
        super().__init__()
        self.linear_projection = nn.Linear(size, size)
        self.linear_gate = nn.Linear(size, size)
        if gen is not None:
            init_linear(self.linear_projection, gen)
            init_linear(self.linear_gate, gen)

    def forward(self, x: torch.Tensor, relu_proj: bool = False) -> torch.Tensor:
        return highway(self, x, relu_proj)
