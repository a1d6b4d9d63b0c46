"""CNN + Highway front end, one per modality.

Counterpart of `multimodal_transformer_tpu/models/frontend.py`: every
[B, W, F, D] window tensor goes through Conv1d(k=2) + max over the frames
and a Highway gate, then, in training, hash dropout (p = 0.3) over the flat
[B, W, E] positions.  Dispatch follows the port's rule: a CUDA tensor takes
kernel 10 (`WindowEmbedHighway`, ops/cuda/window_embed.py: kernel forward,
plain VJP backward); a CPU tensor, `plain=True`, or the B1-LSTM Highway
(`relu_proj=True`, ReLU on the projection, which the kernel does not
compute, as the Pallas kernel does not) take the plain conv (one
pair-concat matmul) + Highway with autograd.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.basic import Highway, conv1d_window_embed, dropout
from ..ops.cuda.window_embed import WindowEmbedHighway
from ..ops.dispatch import use_kernel
from ..utils import prng
from ..utils.init import conv1d_init, linear_init

DROPOUT = 0.3


class CNN(nn.Module):
    def __init__(self, in_dim: int, embed: int, k: int = 2):
        super().__init__()
        self.conv1d = nn.Conv1d(in_dim, embed, k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv1d_window_embed(x, self.conv1d.weight, self.conv1d.bias)


def add_frontend(module: nn.Module, mods, dims, window_embed_size) -> None:
    """Registers cnn_<mod> and highway_<mod> on module, in the JAX
    package's parameter names."""
    for m in mods:
        e = window_embed_size[m]
        setattr(module, f"cnn_{m}", CNN(dims[m], e))
        setattr(module, f"highway_{m}", Highway(e))


def frontend_init(key, mods, dims, window_embed_size, k: int = 2,
                  device="cpu") -> dict:
    """The JAX package's `frontend_init` tree: split(key, 3 * len(mods)),
    three keys a modality (conv, Highway projection, Highway gate)."""
    keys = prng.split(key, 3 * len(mods))
    params = {}
    for i, m in enumerate(mods):
        e = window_embed_size[m]
        params[f"cnn_{m}"] = {"conv1d": conv1d_init(keys[3 * i], dims[m], e, k,
                                                    device)}
        params[f"highway_{m}"] = {
            "linear_projection": linear_init(keys[3 * i + 1], e, e, device),
            "linear_gate": linear_init(keys[3 * i + 2], e, e, device)}
    return params


def frontend_apply(module: nn.Module, inputs, mods, seeds=None, *,
                   relu_proj: bool = False, plain: bool = False) -> dict:
    """inputs: mod -> [B, W, F, D]; seeds: mod -> dropout seed (or threefry
    key, whose mask is applied here in torch after kernel 10 as the hash's
    is) in training, None in eval.  Returns mod -> [B, W, E_mod]."""
    outs = {}
    for m in mods:
        x = inputs[m]
        cnn, hw = getattr(module, f"cnn_{m}"), getattr(module, f"highway_{m}")
        if use_kernel(x) and not relu_proj and not plain:
            y = WindowEmbedHighway.apply(
                x, cnn.conv1d.weight, cnn.conv1d.bias,
                hw.linear_projection.weight, hw.linear_projection.bias,
                hw.linear_gate.weight, hw.linear_gate.bias)
        else:
            y = hw(cnn(x), relu_proj)
        outs[m] = dropout(y, None if seeds is None else seeds[m], DROPOUT)
    return outs
