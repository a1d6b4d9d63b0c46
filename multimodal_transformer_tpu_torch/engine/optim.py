"""Optimizer: torch's Adam with coupled L2 weight decay, and a
ReduceLROnPlateau controller.

Counterpart of `multimodal_transformer_tpu/engine/optim.py`.  The reference
trains with `optim.Adam(params, lr=1e-4, weight_decay=1e-4)` and
`ReduceLROnPlateau(mode='min', patience=100, factor=0.5)`; the JAX package
re-implements that Adam exactly (weight decay added to the gradient, the
denominator sqrt(v_hat) + eps), so the port uses `torch.optim.Adam` itself.
"""

from __future__ import annotations

import dataclasses

import torch


def make_adam(params, lr: float = 1e-4,
              weight_decay: float = 1e-4) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, weight_decay=weight_decay)


@dataclasses.dataclass
class ReduceLROnPlateau:
    """Host-side plateau controller matching torch's defaults
    (mode='min', threshold=1e-4 relative, cooldown=0, min_lr=0)."""
    lr: float
    patience: int = 100
    factor: float = 0.5
    threshold: float = 1e-4
    best: float = float("inf")
    num_bad: int = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr *= self.factor
                self.num_bad = 0
        return self.lr
