"""Port parity: LayerNorm, linear, windowed CNN embed and Highway against the
JAX package's ops/norm.py and ops/basic.py, float32 on the CPU, atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_transformer_tpu.ops import basic as jbasic
from multimodal_transformer_tpu.ops import norm as jnorm
from multimodal_transformer_tpu_torch.ops import basic, norm

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _arr(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


def test_layer_norm():
    rs = np.random.RandomState(0)
    x, a, b = _arr(rs, 3, 5, 16), _arr(rs, 16), _arr(rs, 16)
    want = jnorm.torch_layer_norm({"a_2": a, "b_2": b}, jnp.asarray(x))
    got = norm.layer_norm(torch.from_numpy(x), torch.from_numpy(a),
                          torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_layer_norm_module_defaults():
    rs = np.random.RandomState(1)
    x = _arr(rs, 4, 9)
    ln = norm.LayerNorm(9)
    want = jnorm.torch_layer_norm({"a_2": np.ones(9, np.float32),
                                   "b_2": np.zeros(9, np.float32)},
                                  jnp.asarray(x))
    with torch.no_grad():
        got = ln(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_linear():
    rs = np.random.RandomState(2)
    x, w, b = _arr(rs, 4, 6, 10), _arr(rs, 7, 10), _arr(rs, 7)
    want = jbasic.linear({"weight": w, "bias": b}, jnp.asarray(x))
    got = basic.linear(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_conv1d_window_embed():
    rs = np.random.RandomState(3)
    x, w, b = _arr(rs, 2, 3, 5, 8), _arr(rs, 6, 8, 2), _arr(rs, 6)
    want = jbasic.conv1d_window_embed({"weight": w, "bias": b}, jnp.asarray(x))
    got = basic.conv1d_window_embed(torch.from_numpy(x), torch.from_numpy(w),
                                    torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # and it is the reference's Conv1d(k=2) + max-pool over the frames
    conv = torch.nn.functional.conv1d(
        torch.from_numpy(x).reshape(6, 5, 8).transpose(1, 2),
        torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_allclose(got.reshape(6, 6).numpy(),
                               conv.amax(dim=-1).numpy(), atol=ATOL)


@pytest.mark.parametrize("relu_proj", [False, True])
def test_highway(relu_proj):
    rs = np.random.RandomState(4)
    x = _arr(rs, 2, 3, 6)
    p = {"linear_projection": {"weight": _arr(rs, 6, 6), "bias": _arr(rs, 6)},
         "linear_gate": {"weight": _arr(rs, 6, 6), "bias": _arr(rs, 6)}}
    want = jbasic.highway(p, jnp.asarray(x), relu_proj=relu_proj)
    hw = basic.Highway(6)
    with torch.no_grad():
        for name in ("linear_projection", "linear_gate"):
            getattr(hw, name).weight.copy_(torch.from_numpy(p[name]["weight"]))
            getattr(hw, name).bias.copy_(torch.from_numpy(p[name]["bias"]))
        got = hw(torch.from_numpy(x), relu_proj=relu_proj)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
