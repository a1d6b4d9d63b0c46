"""Port parity for the evaluation metrics (`ops/metrics.py`) against
`multimodal_transformer_tpu.ops.metrics`, on the CPU.

`ccc` and `pearson` are the same float64 numpy arithmetic on both sides:
equal within 1e-12.  `ccc_masked` and `masked_mse_sum` run in float32 on
both sides (torch here, jnp there), summing in another order: 1e-6
relative.  `ccc_masked` is also held to the host `ccc` of each video's
valid prefix within 1e-5 (float32 against float64), and gives 0 for a row
with no step or a zero denominator.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_transformer_tpu.ops import metrics as jmetrics
from multimodal_transformer_tpu_torch.ops import metrics

LENS = [40, 17, 1, 0, 33, 40]


@pytest.fixture(scope="module")
def batch():
    rs = np.random.RandomState(0)
    B, T = len(LENS), 40
    y = rs.randn(B, T).astype(np.float32)
    p = (0.6 * y + 0.5 * rs.randn(B, T) + 0.1).astype(np.float32)
    p[5] = y[5] = 0.0  # zero target and prediction: zero denominator
    mask = np.zeros((B, T), np.float32)
    for b, n in enumerate(LENS):
        mask[b, :n] = 1.0
    return y * mask, p * mask, mask


@pytest.mark.parametrize("fn", ["ccc", "pearson"])
@pytest.mark.parametrize("n", [40, 17, 2])
def test_host_metrics_match_jax(batch, fn, n):
    y, p, _ = batch
    got = getattr(metrics, fn)(y[0, :n], p[0, :n])
    want = getattr(jmetrics, fn)(y[0, :n], p[0, :n])
    assert got == pytest.approx(want, rel=1e-12, abs=1e-12)


def test_ccc_masked_matches_jax(batch):
    y, p, mask = batch
    got = metrics.ccc_masked(torch.from_numpy(y), torch.from_numpy(p),
                             torch.from_numpy(mask)).numpy()
    want = np.asarray(jmetrics.ccc_masked(jnp.asarray(y), jnp.asarray(p),
                                          jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_ccc_masked_matches_host_ccc_and_is_never_nan(batch):
    y, p, mask = batch
    got = metrics.ccc_masked(torch.from_numpy(y), torch.from_numpy(p),
                             torch.from_numpy(mask)).numpy()
    assert np.isfinite(got).all()
    for b, n in enumerate(LENS):
        if n < 2 or b == 5:  # no variance: the host ccc is 0/0
            assert got[b] == 0.0
        else:
            assert got[b] == pytest.approx(metrics.ccc(y[b, :n], p[b, :n]),
                                           abs=1e-5)


def test_masked_mse_sum_matches_jax(batch):
    y, p, _ = batch
    got = float(metrics.masked_mse_sum(torch.from_numpy(p)[..., None],
                                       torch.from_numpy(y)[..., None]))
    want = float(jmetrics.masked_mse_sum(jnp.asarray(p)[..., None],
                                         jnp.asarray(y)[..., None]))
    assert got == pytest.approx(want, rel=1e-6)
