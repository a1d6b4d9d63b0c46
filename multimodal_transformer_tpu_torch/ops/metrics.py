"""Evaluation metrics: CCC, Pearson r, masked CCC and summed squared error.

Counterpart of `multimodal_transformer_tpu/ops/metrics.py`.  The CCC is the
reference's (MFT/train.py:42-50) with the biased (population) variance and
covariance:

    ccc = 2 cov(y, yhat) / (var_y + var_yhat + (mean_y - mean_yhat)^2)

`ccc` and `pearson` run on the host in numpy float64, as the reference's
per-video evaluation does; `ccc_masked` and `masked_mse_sum` run in torch on
the device, over a padded batch.
"""

from __future__ import annotations

import numpy as np
import torch


def ccc(y_true, y_pred):
    """Concordance correlation coefficient of two 1-D traces (host)."""
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    true_mean, pred_mean = y_true.mean(), y_pred.mean()
    true_var, pred_var = y_true.var(), y_pred.var()
    covar = ((y_true - true_mean) * (y_pred - pred_mean)).mean()
    return 2 * covar / (true_var + pred_var + (pred_mean - true_mean) ** 2)


def pearson(y_true, y_pred):
    """Pearson correlation of two 1-D traces (host)."""
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    yt = y_true - y_true.mean()
    yp = y_pred - y_pred.mean()
    denom = np.sqrt((yt * yt).sum() * (yp * yp).sum())
    return float((yt * yp).sum() / denom)


def ccc_masked(y_true: torch.Tensor, y_pred: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Per-row CCC of a batch on the device.  y_true, y_pred, mask: [B, T],
    mask in {0, 1}; the statistics run over the masked-in steps only.  A row
    with no step, or with zero denominator, gives 0, not NaN.  Returns
    [B]."""
    mask = mask.to(y_true.dtype)
    n = mask.sum(dim=1)
    n_safe = n.clamp(min=1.0)

    def mean(x):
        return (x * mask).sum(dim=1) / n_safe

    mt, mp = mean(y_true), mean(y_pred)
    dt = (y_true - mt[:, None]) * mask
    dp = (y_pred - mp[:, None]) * mask
    var_t = (dt * dt).sum(dim=1) / n_safe
    var_p = (dp * dp).sum(dim=1) / n_safe
    covar = (dt * dp).sum(dim=1) / n_safe
    denom = var_t + var_p + (mp - mt) ** 2
    ok = (n > 0) & (denom > 0)
    return torch.where(ok, 2 * covar / torch.where(denom > 0, denom,
                                                   torch.ones_like(denom)),
                       torch.zeros_like(denom))


def masked_mse_sum(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Sum of squared errors (the reference's MSELoss(reduction='sum')):
    every head zeroes its padded steps and the targets are zero-padded, so
    padding adds exactly 0."""
    d = pred - target
    return (d * d).sum()
