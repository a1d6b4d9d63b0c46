"""Port parity of the recurrent primitives against the JAX package's
ops/recurrent.py, float32 on the CPU, atol 1e-5: the LSTM cell step, the
LSTM scan (with and without an initial state), pad_shift (shift 0, +-k and
|shift| >= T) and the causal local-attention convolution."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_transformer_tpu.ops import recurrent as jrec
from multimodal_transformer_tpu_torch.ops import recurrent

ATOL = 1e-5


def _cell(rs, D, H):
    """An LSTMCell with numpy weights, and the same weights as a JAX dict."""
    p = {"weight_ih": rs.randn(4 * H, D), "weight_hh": rs.randn(4 * H, H),
         "bias_ih": rs.randn(4 * H), "bias_hh": rs.randn(4 * H)}
    p = {k: (0.3 * v).astype(np.float32) for k, v in p.items()}
    cell = torch.nn.LSTMCell(D, H)
    with torch.no_grad():
        for k, v in p.items():
            getattr(cell, k).copy_(torch.from_numpy(v))
    return cell, p


def _arr(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


def test_lstm_cell_step():
    rs = np.random.RandomState(0)
    cell, p = _cell(rs, 6, 5)
    x, h, c = _arr(rs, 3, 6), _arr(rs, 3, 5), _arr(rs, 3, 5)
    want = jrec.lstm_cell_step(p, jnp.asarray(x), jnp.asarray(h),
                               jnp.asarray(c))
    with torch.no_grad():
        got = recurrent.lstm_cell_step(cell, torch.from_numpy(x),
                                       torch.from_numpy(h), torch.from_numpy(c))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_lstm_scan(with_state):
    rs = np.random.RandomState(1)
    cell, p = _cell(rs, 7, 4)
    xs = _arr(rs, 2, 9, 7)
    h0, c0 = (_arr(rs, 2, 4), _arr(rs, 2, 4)) if with_state else (None, None)
    j = lambda a: None if a is None else jnp.asarray(a)
    t = lambda a: None if a is None else torch.from_numpy(a)
    want_hs, (want_h, want_c) = jrec.lstm_scan(p, jnp.asarray(xs), j(h0),
                                               j(c0))
    with torch.no_grad():
        hs, (h, c) = recurrent.lstm_scan(cell, torch.from_numpy(xs), t(h0),
                                         t(c0))
    np.testing.assert_allclose(hs.numpy(), np.asarray(want_hs), atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=ATOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(want_c), atol=ATOL)


@pytest.mark.parametrize("shift", [0, 1, 3, -2, 6, 9, -6, -11])
def test_pad_shift(shift):
    x = _arr(np.random.RandomState(2), 2, 6, 3)
    want = jrec.pad_shift(jnp.asarray(x), shift, padv=0.5)
    got = recurrent.pad_shift(torch.from_numpy(x), shift, padv=0.5)
    assert got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("T,K", [(8, 5), (3, 5)])
def test_convolve_local_attn(T, K):
    rs = np.random.RandomState(3)
    x, attn = _arr(rs, 2, T, 4), _arr(rs, 2, T, K)
    want = jrec.convolve_local_attn(jnp.asarray(x), jnp.asarray(attn))
    got = recurrent.convolve_local_attn(torch.from_numpy(x),
                                        torch.from_numpy(attn))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
