"""Port parity for kernel 11 (flash attention) and the long-video encoder
route, on the CPU.

  * `flash_attention_masked_plain` (the kernel's CPU path) against the
    Pallas `flash_attention_masked` in interpret mode, on 4 x 4 tiles so
    that several query and key tiles and a ragged tail are crossed, with
    partly and wholly masked videos: float32 within 1e-5 (float32 sums in
    another order, and exp), bf16 within rtol = atol = 2^-7 (one bf16 step
    at magnitude 1): both scale q by 1/sqrt(d_k) rounded to bf16 and sum in
    float32, but XLA on the CPU keeps q * scale in float32 up to the dot
    (excess precision), where the port rounds it to bf16 as the TPU's matrix
    unit, which takes bf16, does; that moves each score by up to 2^-9 of
    itself, and the outputs by up to 0.0039 here.  A video with no key is
    compared only where T is a multiple of the tile: the Pallas kernel pads
    the keys to its tile with zeros and masks them, so such a row averages
    v over the padded length, where the port (and the dense function that
    the JAX backward differentiates) averages over the T keys;
  * padding invariance: masked keys appended to a video change none of its
    rows (float32, 1e-6: softmax over a longer row sums in another order);
  * a video whose keys are all masked gives the uniform mean of v;
  * `FlashAttention` gradients against `jax.grad` through
    `flash_attention_trainable` in interpret mode (as
    tests/test_pallas_kernels.py checks the JAX pair): 1e-5, float32;
  * the encoder's long route (`encoder_stack` at T = 520 > 512, eval,
    "key_query") against the JAX `encoder_stack` with its TPU dispatch
    forced and its flash kernel in interpret mode, at D = 32, h = 4, 2
    layers, on valid rows within 1e-4 (as tests/test_torch_encoder.py); the
    route is taken by making the CPU tensor look like a CUDA one, and the
    wrapper is counted: 2 flash calls (one per layer), no kernel A call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_transformer_tpu.ops import attention as jattn
from multimodal_transformer_tpu.ops import dispatch as jdispatch
from multimodal_transformer_tpu.ops.pallas import attention as pattn
from multimodal_transformer_tpu_torch.ops import attention
from multimodal_transformer_tpu_torch.ops import dispatch
from multimodal_transformer_tpu_torch.ops.cuda import encoder as enc_k
from multimodal_transformer_tpu_torch.ops.cuda import flash_attention as fa_k
from multimodal_transformer_tpu_torch.utils.params import load_jax_params
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401


H = 2


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _case(seed, B, T, d_k, lens):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(B * H, T, d_k).astype(np.float32) for _ in range(3))
    kmask = np.zeros((B, T), np.float32)
    for b, n in enumerate(lens):
        kmask[b, :n] = 1.0
    return q, k, v, kmask


def _compared(kmask, tile=4):
    """Rows [B*H] to compare: every row, except those of a video with no key
    when T is not a multiple of the Pallas tile."""
    keep = (kmask.sum(axis=1) > 0) | (kmask.shape[1] % tile == 0)
    return np.repeat(keep, H)


def _jax_flash(q, k, v, kmask, dtype):
    out = pattn.flash_attention_masked(
        jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
        jnp.asarray(np.repeat(kmask, H, axis=0)), blk_q=4, blk_k=4,
        interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _port_flash(q, k, v, kmask, dtype):
    t = lambda a: torch.from_numpy(a).to(dtype)
    out = fa_k.flash_attention_masked(t(q), t(k), t(v),
                                      torch.from_numpy(kmask), H)
    assert out.dtype == dtype
    return out.float().numpy()


@pytest.mark.parametrize("d_k", [2, 32])
@pytest.mark.parametrize("T,lens", [(13, [13, 9, 1]), (16, [16, 0, 5]),
                                    (7, [3, 7, 0])])
def test_plain_flash_matches_pallas_interpret_fp32(T, lens, d_k):
    q, k, v, kmask = _case(0, len(lens), T, d_k, lens)
    rows = _compared(kmask)
    np.testing.assert_allclose(
        _port_flash(q, k, v, kmask, torch.float32)[rows],
        _jax_flash(q, k, v, kmask, jnp.float32)[rows], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d_k", [2, 32])
def test_plain_flash_matches_pallas_interpret_bf16(d_k):
    q, k, v, kmask = _case(1, 3, 16, d_k, [13, 6, 0])
    np.testing.assert_allclose(_port_flash(q, k, v, kmask, torch.bfloat16),
                               _jax_flash(q, k, v, kmask, jnp.bfloat16),
                               rtol=2 ** -7, atol=2 ** -7)


def test_plain_flash_is_padding_invariant():
    q, k, v, kmask = _case(2, 2, 11, 8, [11, 4])
    pad = 21
    grow = lambda a: np.concatenate(
        [a, np.random.RandomState(3).randn(a.shape[0], pad - a.shape[1],
                                           *a.shape[2:]).astype(np.float32)],
        axis=1)
    kmask_p = np.zeros((2, pad), np.float32)
    kmask_p[:, :11] = kmask
    short = _port_flash(q, k, v, kmask, torch.float32)
    long = _port_flash(q, grow(k), grow(v), kmask_p, torch.float32)
    np.testing.assert_allclose(long, short, rtol=0, atol=1e-6)


def test_all_masked_video_is_the_uniform_mean_of_v():
    q, k, v, kmask = _case(4, 2, 9, 32, [0, 5])
    out = _port_flash(q, k, v, kmask, torch.float32)
    assert np.isfinite(out).all()
    want = np.broadcast_to(v[:H].mean(axis=1, keepdims=True), (H, 9, 32))
    np.testing.assert_allclose(out[:H], want, rtol=1e-6, atol=1e-6)


def test_flash_function_grads_match_jax_grad(monkeypatch):
    orig = pattn.flash_attention_masked
    monkeypatch.setattr(
        pattn, "flash_attention_masked",
        lambda *a, **kw: orig(*a, **{**kw, "blk_q": 4, "blk_k": 4,
                                     "interpret": True}))
    q, k, v, kmask = _case(5, 3, 10, 8, [10, 7, 0])
    rs = np.random.RandomState(6)
    cot = rs.randn(*q.shape).astype(np.float32)
    jmask = jnp.asarray(np.repeat(kmask, H, axis=0))

    def loss(q, k, v):
        return jnp.sum(pattn.flash_attention_trainable(q, k, v, jmask) * cot)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    y = fa_k.FlashAttention.apply(*leaves, torch.from_numpy(kmask), H)
    (y * torch.from_numpy(cot)).sum().backward()
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("T,mode,training,want", [
    (512, "key_query", False, "fused"), (513, "key_query", False, "flash"),
    (1120, "key_query", False, "flash"), (1120, "key_query", True, "train"),
    (160, "key_query", True, "train"), (1120, "query", False, "plain"),
    (160, "query", True, "plain")])
def test_encoder_route(T, mode, training, want):
    assert dispatch.encoder_route(True, T, mode, training) == want
    assert dispatch.encoder_route(False, T, mode, training) == "plain"


@pytest.mark.parametrize("T,mode,training,want", [
    (160, "key_query", True, "train_stack"),
    (1120, "key_query", True, "train_stack"),
    (160, "key_query", False, "fused"), (1120, "key_query", False, "flash"),
    (160, "query", True, "plain")])
def test_encoder_route_with_the_stack_backward(T, mode, training, want):
    """backward="stack" changes only the training route on the card; an
    unknown backward raises."""
    assert dispatch.encoder_route(True, T, mode, training, "stack") == want
    assert dispatch.encoder_route(False, T, mode, training, "stack") == \
        "plain"
    with pytest.raises(ValueError, match="encoder_backward"):
        dispatch.encoder_route(True, T, mode, training, "chunked")


# the long route against the JAX package's: D = 32, h = 4 (d_k = 8), F = 16
D, HEADS, F, N_LAYERS = 32, 4, 16, 2


def _lin(rs, fan_in, fan_out):
    k = fan_in ** -0.5
    return {"weight": rs.uniform(-k, k, (fan_out, fan_in)).astype(np.float32),
            "bias": rs.uniform(-k, k, fan_out).astype(np.float32)}


def _norm(rs):
    return {"a_2": (1 + 0.1 * rs.randn(D)).astype(np.float32),
            "b_2": (0.1 * rs.randn(D)).astype(np.float32)}


@pytest.fixture(scope="module")
def encoder_case():
    rs = np.random.RandomState(7)
    layers = [{"self_attn": {"linears": [_lin(rs, D, D) for _ in range(4)]},
               "feed_forward": {"w_1": _lin(rs, D, F), "w_2": _lin(rs, F, D)},
               "sublayer": [{"norm": _norm(rs)}, {"norm": _norm(rs)}]}
              for _ in range(N_LAYERS)]
    params = {"layers": layers, "norm": _norm(rs)}
    enc = load_jax_params(attention.Encoder(D, F, N_LAYERS), params).eval()
    return params, enc, rs


@pytest.fixture
def routed(monkeypatch):
    """CPU tensors take the CUDA routes; the wrappers check their arguments
    as on the card, record their calls and run their plain versions."""
    calls = []
    monkeypatch.setattr(attention, "use_kernel", lambda t: True)

    def flash(*a):
        fa_k._check(*a)  # what the kernel would take
        calls.append("flash")
        return fa_k.flash_attention_masked_plain(*a)

    def fused(*a, **k):
        calls.append("fused")
        return enc_k.encoder_stack_fused_plain(*a, **k)

    monkeypatch.setattr(fa_k, "flash_attention_masked", flash)
    monkeypatch.setattr(enc_k, "encoder_stack_fused", fused)
    return calls


def test_long_route_matches_jax_flash_route(encoder_case, routed,
                                            monkeypatch):
    params, enc, rs = encoder_case
    B, T = 2, 520
    x = rs.randn(B, T, D).astype(np.float32)
    mask = np.zeros((B, T, 1), np.float32)
    mask[0, :T] = 1.0
    mask[1, :300] = 1.0

    monkeypatch.setattr(jdispatch, "_on_tpu", lambda: True)
    for var in ("MMTX_PALLAS", "MMTX_PALLAS_ATTN", "MMTX_PALLAS_ENCODER"):
        monkeypatch.delenv(var, raising=False)
    jcalls = []
    orig = pattn.flash_attention_masked

    def jflash(*a, **kw):
        jcalls.append(1)
        return orig(*a, **{**kw, "interpret": True})

    monkeypatch.setattr(pattn, "flash_attention_masked", jflash)
    want = jattn.encoder_stack(params, jnp.asarray(x), jnp.asarray(mask),
                               h=HEADS, rng=None, mask_mode="key_query")
    assert len(jcalls) == N_LAYERS  # the JAX package took its flash route

    with torch.no_grad():
        got = attention.encoder_stack(enc, torch.from_numpy(x),
                                      torch.from_numpy(mask), h=HEADS,
                                      mask_mode="key_query")
    assert routed == ["flash"] * N_LAYERS
    valid = mask[..., 0].astype(bool)
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid],
                               atol=1e-4)


def test_plain_paths_take_no_kernel_route(encoder_case, routed):
    """encoder_stack_plain, and encoder_stack at T <= 512, never reach
    kernel 11; T <= 512 takes kernel A."""
    _, enc, rs = encoder_case
    for T in (512, 520):
        x = torch.from_numpy(rs.randn(1, T, D).astype(np.float32))
        mask = torch.ones(1, T, 1)
        with torch.no_grad():
            attention.encoder_stack_plain(enc, x, mask, h=HEADS,
                                          mask_mode="key_query")
    assert routed == []
    x = torch.from_numpy(rs.randn(1, 512, D).astype(np.float32))
    with torch.no_grad():
        attention.encoder_stack(enc, x, torch.ones(1, 512, 1), h=HEADS,
                                mask_mode="key_query")
    assert routed == ["fused"]
