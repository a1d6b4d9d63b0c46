"""Kernel 10's plain version and autograd Function against the JAX
package's Pallas window-embed kernel, run as the JAX tests run it (interpret
mode on the CPU), float32:

  * `window_embed_highway_plain` against `fused_window_embed_highway(...,
    interpret=True)`, with tile padding (N not a multiple of the tile) and
    ragged D and E, atol 1e-5;
  * the gradients of `WindowEmbedHighway` (on the CPU its forward is the
    plain version) for x and all six parameters against `jax.grad` of
    `window_embed_highway_trainable` in interpret mode, atol 1e-5;
  * with x as data (no gradient wanted) the Function returns no gradient
    for it and the same parameter gradients;
  * the front end dispatches: CPU tensors and plain=True take the plain
    conv + Highway, relu_proj is the B1 variant;
  * the kernel's bound takes the slower of the tensor cores and the FMA
    pipes, and adds float32 conv and highway products on the FMA pipes;
  * the wrapper raises for F < 2 and for mismatched weights on any device
    that would launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_transformer_tpu.ops.pallas.window_embed as jwe
from multimodal_transformer_tpu.models import frontend as jfrontend
from multimodal_transformer_tpu_torch.models.frontend import (add_frontend,
                                                              frontend_apply)
from multimodal_transformer_tpu_torch.ops.cuda import window_embed as we
from multimodal_transformer_tpu_torch.utils.params import load_jax_params
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401


ATOL = 1e-5
NAMES = ("x", "conv_w", "conv_b", "wp", "bp", "wg", "bg")


def _case(seed, B, W, F, D, E):
    rs = np.random.RandomState(seed)
    k1, k2 = (2 * D) ** -0.5, E ** -0.5
    arrs = {"x": rs.randn(B, W, F, D),
            "conv_w": rs.uniform(-k1, k1, (E, D, 2)),
            "conv_b": rs.uniform(-k1, k1, E),
            "wp": rs.uniform(-k2, k2, (E, E)), "bp": rs.uniform(-k2, k2, E),
            "wg": rs.uniform(-k2, k2, (E, E)), "bg": rs.uniform(-k2, k2, E)}
    return {k: v.astype(np.float32) for k, v in arrs.items()}


def _jax_trees(a):
    conv = {"weight": jnp.asarray(a["conv_w"]), "bias": jnp.asarray(a["conv_b"])}
    hw = {"linear_projection": {"weight": jnp.asarray(a["wp"]),
                                "bias": jnp.asarray(a["bp"])},
          "linear_gate": {"weight": jnp.asarray(a["wg"]),
                          "bias": jnp.asarray(a["bg"])}}
    return conv, hw, jnp.asarray(a["x"])


def _torch_args(a, requires_grad=False):
    return [torch.from_numpy(a[k]).requires_grad_(requires_grad)
            for k in NAMES]


# (B, W, F, D, E, tile_n): N = B*W windows; tile padding where N % tile_n
# != 0; D and E off every power of two
SHAPES = [(2, 5, 4, 24, 16, 4), (3, 7, 3, 9, 13, 8), (1, 6, 2, 5, 7, 4),
          (2, 3, 33, 11, 6, 8)]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_interpret(shape):
    B, W, F, D, E, tile_n = shape
    a = _case(0, B, W, F, D, E)
    want = jwe.fused_window_embed_highway(*_jax_trees(a), tile_n=tile_n,
                                          interpret=True)
    got = we.window_embed_highway_plain(*_torch_args(a))
    assert got.shape == (B, W, E)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # on a CPU tensor the wrapper is the plain version
    np.testing.assert_array_equal(
        we.window_embed_highway(*_torch_args(a)).numpy(), got.numpy())


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_function_grads_match_jax(shape, monkeypatch):
    B, W, F, D, E, _ = shape
    orig = jwe.fused_window_embed_highway
    monkeypatch.setattr(jwe, "fused_window_embed_highway",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    a = _case(1, B, W, F, D, E)
    g = np.random.RandomState(2).randn(B, W, E).astype(np.float32)

    def loss(conv, hw, x):
        return jnp.sum(jwe.window_embed_highway_trainable(conv, hw, x)
                       * jnp.asarray(g))

    gc, gh, gx = jax.grad(loss, argnums=(0, 1, 2))(*_jax_trees(a))
    want = [gx, gc["weight"], gc["bias"],
            gh["linear_projection"]["weight"], gh["linear_projection"]["bias"],
            gh["linear_gate"]["weight"], gh["linear_gate"]["bias"]]
    args = _torch_args(a, requires_grad=True)
    y = we.WindowEmbedHighway.apply(*args)
    got = torch.autograd.grad(y, args, torch.from_numpy(g))
    for name, gt, w in zip(NAMES, got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(w), atol=ATOL,
                                   err_msg=name)


def test_function_leaves_out_the_data_gradient(monkeypatch):
    B, W, F, D, E, _ = SHAPES[0]
    a = _case(3, B, W, F, D, E)
    g = torch.from_numpy(np.random.RandomState(4).randn(B, W, E).astype(
        np.float32))
    full = _torch_args(a, requires_grad=True)
    want = torch.autograd.grad(we.WindowEmbedHighway.apply(*full), full[1:], g)
    args = _torch_args(a, requires_grad=True)
    args[0].requires_grad_(False)
    asked = []
    grad = torch.autograd.grad
    monkeypatch.setattr(torch.autograd, "grad", lambda out, ins, *a, **kw:
                        asked.append(len(ins)) or grad(out, ins, *a, **kw))
    y = we.WindowEmbedHighway.apply(*args)
    y.backward(g)
    assert asked == [6]  # the recompute's VJP is taken for the weights only
    assert args[0].grad is None
    for name, t, w in zip(NAMES[1:], args[1:], want):
        np.testing.assert_array_equal(t.grad.numpy(), w.numpy(), err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_embed_bound_counts_each_pipe(dtype):
    from multimodal_transformer_tpu_torch.ops.cuda import verify

    N, Fr, D, E = 5120, 32, 300, 300
    conv, highway = 2.0 * N * (Fr - 1) * 2 * D * E, 4.0 * N * E * E
    ops = verify.window_embed_ops(N, Fr, D, E, dtype)
    if dtype == torch.bfloat16:
        assert ops == {"bf16": conv, "fp32": highway}
        want = max(conv / 989e12, highway / 67e12)
    else:
        assert ops == {"fp32": conv + highway}
        want = (conv + highway) / 67e12
    ops_ms, bytes_ms = verify.bound_times(ops, [torch.empty(N, Fr, D,
                                                            dtype=dtype)])
    assert ops_ms == pytest.approx(1e3 * want)
    assert bytes_ms == pytest.approx(
        1e3 * N * Fr * D * (2 if dtype == torch.bfloat16 else 4) / 3.35e12)


@pytest.mark.parametrize("relu_proj", [False, True])
def test_frontend_matches_jax_frontend(relu_proj):
    mods, dims, embeds = ("acoustic", "image"), {"acoustic": 6, "image": 9}, \
        {"acoustic": 5, "image": 7}
    params = jax.tree_util.tree_map(np.asarray, jfrontend.frontend_init(
        jax.random.PRNGKey(3), mods, dims, embeds))
    rs = np.random.RandomState(4)
    inputs = {m: rs.randn(2, 3, 4, dims[m]).astype(np.float32) for m in mods}
    want = jfrontend.frontend_apply(params, {m: jnp.asarray(v) for m, v in
                                             inputs.items()}, mods,
                                    relu_proj=relu_proj)
    module = torch.nn.Module()
    add_frontend(module, mods, dims, embeds)
    load_jax_params(module, params)
    with torch.no_grad():
        for plain in (False, True):
            got = frontend_apply(module, {m: torch.from_numpy(v) for m, v in
                                          inputs.items()}, mods,
                                 relu_proj=relu_proj, plain=plain)
            for m in mods:
                np.testing.assert_allclose(got[m].numpy(),
                                           np.asarray(want[m]), atol=ATOL)


def test_wrapper_checks_what_the_kernel_takes():
    a = _case(5, 1, 2, 1, 4, 3)
    args = _torch_args(a)
    with pytest.raises(ValueError, match="F >= 2"):
        we._check(*args)
    a = _case(5, 1, 2, 3, 4, 3)
    args = _torch_args(a)
    args[3] = args[3][:, :2]
    with pytest.raises(ValueError, match="wp must be"):
        we._check(*args)
    args = _torch_args(a)
    args[0] = args[0].double()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        we._check(*args)
