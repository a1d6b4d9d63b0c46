"""Carry parameter trees between the JAX package and the port.

The JAX package keeps parameters as nested dicts and lists in torch layout;
the port names its modules so that the tree flattened with "." (list
entries by index, e.g. `Transformer.transformer_image.layers.3.self_attn.
linears.0.weight`) equals `state_dict()` key for key.  Loading is a copy,
with no renaming and no transposes.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def flatten_tree(tree, prefix: str = "") -> dict:
    """Nested dicts/lists of arrays -> {"a.b.0.c": array}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def unflatten_tree(flat: dict):
    """Inverse of flatten_tree: all-digit keys become list indices."""
    root: dict = {}
    for key, value in flat.items():
        node = root
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def load_jax_params(module: nn.Module, tree) -> nn.Module:
    """Copy a JAX parameter tree (numpy arrays, or tensors as the port's
    initialisers draw them) into module's parameters, in place.  The keys
    and shapes must match exactly; values are cast to each parameter's
    dtype and device."""
    flat = flatten_tree(tree)
    state = module.state_dict()
    missing = sorted(set(state) - set(flat))
    extra = sorted(set(flat) - set(state))
    if missing or extra:
        raise KeyError(f"parameter trees differ: missing {missing[:5]}, "
                       f"unexpected {extra[:5]}")
    with torch.no_grad():
        for k, t in state.items():
            v = flat[k]
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.array(v, dtype=np.float32))
            if tuple(v.shape) != tuple(t.shape):
                raise ValueError(f"{k}: shape {tuple(v.shape)} != "
                                 f"{tuple(t.shape)}")
            t.copy_(v)
    return module


def export_params(module: nn.Module):
    """module's parameters as the JAX package's nested tree of float32
    numpy arrays (copies: later steps on the module do not change them)."""
    return unflatten_tree({k: v.detach().float().cpu().numpy().copy()
                           for k, v in module.state_dict().items()})
