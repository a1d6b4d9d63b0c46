"""Port parity: the encoder stack, float32 on the CPU, atol 1e-4.

D=64, h=4, F=32, 2 layers, B=3, T=13 (not a multiple of 8), lengths
[13, 9, 1].  The port's plain `encoder_stack` is held against the JAX
package's jnp `encoder_stack` in both mask modes; the kernel module's plain
version (`ops/cuda/encoder.py`, the kernel's CPU path) against the Pallas
`encoder_stack_fused` in interpret mode, on valid rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_transformer_tpu.ops import attention as jattn
from multimodal_transformer_tpu.ops.pallas import encoder as jenc
from multimodal_transformer_tpu_torch.ops import attention
from multimodal_transformer_tpu_torch.ops.cuda import encoder as enc_k
from multimodal_transformer_tpu_torch.utils.params import load_jax_params

D, H, F, N_LAYERS, B, T = 64, 4, 32, 2, 3, 13
LENGTHS = [13, 9, 1]
ATOL = 1e-4


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _lin(rs, fan_in, fan_out):
    k = fan_in ** -0.5
    return {"weight": rs.uniform(-k, k, (fan_out, fan_in)).astype(np.float32),
            "bias": rs.uniform(-k, k, fan_out).astype(np.float32)}


def _norm(rs):
    return {"a_2": (1 + 0.1 * rs.randn(D)).astype(np.float32),
            "b_2": (0.1 * rs.randn(D)).astype(np.float32)}


@pytest.fixture(scope="module")
def case():
    """Distinct random layers (numpy), x and mask; the same arrays go to
    JAX and, copied into an Encoder, to the port."""
    rs = np.random.RandomState(0)
    layers = [{"self_attn": {"linears": [_lin(rs, D, D) for _ in range(4)]},
               "feed_forward": {"w_1": _lin(rs, D, F), "w_2": _lin(rs, F, D)},
               "sublayer": [{"norm": _norm(rs)}, {"norm": _norm(rs)}]}
              for _ in range(N_LAYERS)]
    params = {"layers": layers, "norm": _norm(rs)}
    x = rs.randn(B, T, D).astype(np.float32)
    mask = np.zeros((B, T, 1), np.float32)
    for b, n in enumerate(LENGTHS):
        mask[b, :n] = 1.0
    enc = load_jax_params(attention.Encoder(D, F, N_LAYERS), params).eval()
    return params, enc, x, mask


@pytest.mark.parametrize("mask_mode", ["query", "key_query"])
def test_plain_encoder_matches_jnp(case, mask_mode):
    params, enc, x, mask = case
    want = jattn.encoder_stack(params, jnp.asarray(x), jnp.asarray(mask), h=H,
                               rng=None, mask_mode=mask_mode)
    with torch.no_grad():
        got = attention.encoder_stack(enc, torch.from_numpy(x),
                                      torch.from_numpy(mask), h=H,
                                      mask_mode=mask_mode)
    # same math on every row, padded ones included
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_kernel_plain_version_matches_pallas_interpret(case):
    params, enc, x, mask = case
    want = np.asarray(jenc.encoder_stack_fused(
        params, jnp.asarray(x), jnp.asarray(mask), h=H, interpret=True))
    with torch.no_grad():
        got = enc_k.encoder_stack_fused(enc, torch.from_numpy(x),
                                        torch.from_numpy(mask), h=H).numpy()
    valid = mask[..., 0] > 0
    np.testing.assert_allclose(got[valid], want[valid], atol=ATOL)


def test_kernel_plain_version_matches_jnp_key_query(case):
    """On valid rows the kernel's function is the key_query encoder."""
    params, enc, x, mask = case
    want = np.asarray(jattn.encoder_stack(
        params, jnp.asarray(x), jnp.asarray(mask), h=H, rng=None,
        mask_mode="key_query"))
    with torch.no_grad():
        got = enc_k.encoder_stack_fused_plain(
            enc, torch.from_numpy(x), torch.from_numpy(mask), h=H).numpy()
    valid = mask[..., 0] > 0
    np.testing.assert_allclose(got[valid], want[valid], atol=ATOL)


def test_kernel_plain_version_length_one_row_is_finite(case):
    """A video whose keys are all masked but one, and padded rows with no
    valid key at all, stay finite (-1e9, never -inf)."""
    _, enc, x, mask = case
    m = mask.copy()
    m[2, :] = 0.0   # no valid key at all
    with torch.no_grad():
        got = enc_k.encoder_stack_fused_plain(enc, torch.from_numpy(x),
                                              torch.from_numpy(m), h=H)
    assert torch.isfinite(got).all()


def test_cuda_query_mode_raises_without_a_kernel(case, monkeypatch):
    """On CUDA, "query" mode has no kernel, as in the JAX package: the
    dispatch sends it to the plain encoder by mode (eval and training), and
    only "key_query" reaches the kernels.  Checked by routing a CPU tensor
    as if it were on CUDA, with the kernel wrappers replaced by stand-ins
    that record their calls."""
    from multimodal_transformer_tpu_torch.ops.cuda import encoder_train

    params, enc, x, mask = case
    called = []
    monkeypatch.setattr(attention, "use_kernel", lambda t: True)
    monkeypatch.setattr(enc_k, "encoder_stack_fused",
                        lambda *a, **k: called.append("eval") or a[1])
    monkeypatch.setattr(encoder_train, "encoder_stack_train",
                        lambda *a, **k: called.append("train") or a[1])
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    want = jattn.encoder_stack(params, jnp.asarray(x), jnp.asarray(mask), h=H,
                               rng=None, mask_mode="query")
    seeds = torch.arange(N_LAYERS * 4, dtype=torch.int64).view(N_LAYERS, 4)
    with torch.no_grad():
        got = attention.encoder_stack(enc, xt, mt, h=H, mask_mode="query")
        train = attention.encoder_stack(enc, xt, mt, h=H, mask_mode="query",
                                        seeds=seeds)
        plain_train = attention.encoder_stack_plain(
            enc, xt, mt, h=H, mask_mode="query", seeds=seeds)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert torch.equal(train, plain_train)
    assert called == []
    with torch.no_grad():  # eval: a call needing gradients trains at p = 0
        attention.encoder_stack(enc, xt, mt, h=H, mask_mode="key_query")
    attention.encoder_stack(enc, xt, mt, h=H, mask_mode="key_query",
                            seeds=seeds)
    assert called == ["eval", "train"]
