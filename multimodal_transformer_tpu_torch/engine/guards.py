"""Numerical-failure detection in training.

Counterpart of `multimodal_transformer_tpu/engine/guards.py` over a module's
`named_parameters()` (or any iterable of (name, tensor) pairs, or a dict):

  * nonfinite_leaves / assert_finite_tree: the names of the tensors that
    hold a NaN or an infinity, found with one device-to-host copy;
  * NanGuard: checks the loss every step and the parameters every
    `check_every` steps, and raises NonFiniteError naming them, so a
    failure shows at the step it occurs and not epochs later.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Tuple, Union

import torch

Named = Union[Iterable[Tuple[str, torch.Tensor]], dict]


class NonFiniteError(RuntimeError):
    pass


def nonfinite_leaves(named: Named) -> List[str]:
    items = list(named.items() if isinstance(named, dict) else named)
    if not items:
        return []
    with torch.no_grad():
        ok = torch.stack([torch.isfinite(t).all() for _, t in items]).cpu()
    return [name for (name, _), good in zip(items, ok.tolist()) if not good]


def assert_finite_tree(named: Named, what: str = "tree") -> None:
    bad = nonfinite_leaves(named)
    if bad:
        raise NonFiniteError(f"non-finite values in {what}: {bad[:5]}"
                             + (f" (+{len(bad) - 5} more)"
                                if len(bad) > 5 else ""))


class NanGuard:
    def __init__(self, check_every: int = 50):
        self.check_every = check_every
        self.step = 0

    def check(self, loss: float, params: Named = None) -> None:
        self.step += 1
        if not math.isfinite(loss):
            raise NonFiniteError(f"loss became non-finite at step "
                                 f"{self.step}: {loss}")
        if params is not None and self.step % self.check_every == 0:
            assert_finite_tree(params, f"params at step {self.step}")
