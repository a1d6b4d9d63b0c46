"""Kernel A's wgmma path (bf16, d_k in {16, 32}, D in {128, 256}, F = 128), its
arithmetic emulated block by block on the CPU, and the wrapper's choice of
path, key tiling and shared-memory fit.

The CUDA kernel cannot run here, so `_blockwise` repeats its arithmetic in
torch: LN of the fp32 residual stream (mean, unbiased std + 1e-6, times
the reciprocal of the latter) rounded to bf16 as the products' A operand; every product exact in float32 on bf16
inputs with float32 sums, bias added in float32; q = (acc + bias) / sqrt(d_k)
rounded to bf16 after the scale, k and v rounded; the attention in the
kernel's key tiles (`key_tiles`: one tile of the whole key row up to
T = 256, balanced tiles of at most 256 keys and an online softmax past
it), scores in float32, -1e9 for masked keys, a running max from -1e9,
p = 2^(fma(s, log2 e, -m log2 e)), the running sum over p in float32, p
rounded to bf16 for p @ v, the division at the end; the out projection and
FFN2 added to the fp32 residual; the FFN hidden ReLU'd and rounded; the
final LN the same as the others, rounded to bf16 as the output.  It is held to the competitive bound
err <= 2 * err(competitor - fp64) + 1e-6 against two competitors:
  * `encoder_stack_fused_plain` in bf16 (the kernel's CPU path), both
    measured against the plain version in float64 on the same bf16 inputs
    and weights, on every row (rows past a video's length included: both
    compute the same function there), as `verify.check_encoder` does on the
    card;
  * the Pallas `encoder_stack_fused` in interpret mode on the same
    numpy-seeded parameters, carried across by `load_jax_params`, on the
    valid rows (the Pallas kernel pads T to a multiple of 8, which changes
    only padded rows and videos with no key, whose rows are all padding).

Cases: d_k 16 (D = 128) and 32 (D = 256), h = 8, F = 128, 2 layers, B = 3
with lengths (T, 0, ceil(T / 2)): a video with no valid key; T in {1, 137,
160, 300} (one key; ragged tiles; the serving shape; two online tiles).
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_transformer_tpu.ops.pallas import encoder as jenc
from multimodal_transformer_tpu_torch.ops.attention import Encoder
from multimodal_transformer_tpu_torch.ops.cuda import encoder as enc_k
from multimodal_transformer_tpu_torch.utils.params import load_jax_params
from torch_threads import one_torch_thread as _one_torch_thread  # noqa: F401


H, F, N_LAYERS = 8, 128, 2
LOG2E = np.float32(1.4426950408889634)
BF16 = torch.bfloat16


def _lin(rs, fan_in, fan_out):
    k = fan_in ** -0.5
    return {"weight": rs.uniform(-k, k, (fan_out, fan_in)).astype(np.float32),
            "bias": rs.uniform(-k, k, fan_out).astype(np.float32)}


def _norm(rs, D):
    return {"a_2": (1 + 0.1 * rs.randn(D)).astype(np.float32),
            "b_2": (0.1 * rs.randn(D)).astype(np.float32)}


def _case(seed, D, T):
    rs = np.random.RandomState(seed)
    layers = [{"self_attn": {"linears": [_lin(rs, D, D) for _ in range(4)]},
               "feed_forward": {"w_1": _lin(rs, D, F), "w_2": _lin(rs, F, D)},
               "sublayer": [{"norm": _norm(rs, D)}, {"norm": _norm(rs, D)}]}
              for _ in range(N_LAYERS)]
    params = {"layers": layers, "norm": _norm(rs, D)}
    lens = [T, 0, (T + 1) // 2]
    x = rs.randn(len(lens), T, D).astype(np.float32)
    mask = np.zeros((len(lens), T, 1), np.float32)
    for b, n in enumerate(lens):
        mask[b, :n] = 1.0
    enc = load_jax_params(Encoder(D, F, N_LAYERS), params).to(BF16)
    return params, enc, x, mask


def _ln(x, norm):
    """LN rounded to bf16, times the reciprocal of the std + eps."""
    D = x.shape[-1]
    mean = x.sum(-1, keepdim=True) / D
    d = x - mean
    den = torch.sqrt((d * d).sum(-1, keepdim=True) / (D - 1)) + 1e-6
    return (norm.a_2.float() * d * (1 / den) + norm.b_2.float()).to(BF16)


def _mm(a, lin):
    """acc + bias: bf16 products, exact in float32, summed in float32."""
    return a.float() @ lin.weight.float().T + lin.bias.float()


def _attention(q, k, v, kmask, h):
    """The kernel's attention on bf16 q (scaled), k, v [B, T, D]."""
    B, T, D = q.shape
    d_k = D // h
    tiles, keys = enc_k.key_tiles(T)
    qh, kh, vh = (t.float().view(B, T, h, d_k).transpose(1, 2)
                  for t in (q, k, v))
    keep = (kmask != 0)[:, None, None, :]
    m = torch.full((B, h, T, 1), enc_k.NEG_INF)
    l = torch.zeros(B, h, T, 1)
    o = torch.zeros(B, h, T, d_k)
    for k0 in range(0, tiles * keys, keys):
        n = min(keys, T - k0)  # keys past T: p = 0 exactly
        s = qh @ kh[:, :, k0:k0 + n].transpose(-1, -2)
        s = s.masked_fill(~keep[..., k0:k0 + n], enc_k.NEG_INF)
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        a = torch.exp2((m - mn) * LOG2E)
        ml = mn * LOG2E
        # fma(s, log2 e, -m log2 e): one rounding, from float64
        p = torch.exp2((s.double() * float(LOG2E) - ml.double()).float())
        l = l * a + p.sum(-1, keepdim=True)
        o = o * a + p.to(BF16).float() @ vh[:, :, k0:k0 + n]
        m = mn
    return (o / l).transpose(1, 2).reshape(B, T, D).to(BF16)


def _blockwise(enc, x, mask, h=H):
    """The wgmma path's arithmetic on bf16 x [B, T, D] and a bf16 enc."""
    B, T, D = x.shape
    inv_sqrt_dk = torch.tensor(1.0) / torch.sqrt(torch.tensor(float(D // h)))
    xr = x.float().reshape(B * T, D)
    kmask = mask[..., 0]
    for layer in enc.layers:
        lins = layer.self_attn.linears
        xn = _ln(xr, layer.sublayer[0].norm)
        q = (_mm(xn, lins[0]) * inv_sqrt_dk).to(BF16).view(B, T, D)
        k = _mm(xn, lins[1]).to(BF16).view(B, T, D)
        v = _mm(xn, lins[2]).to(BF16).view(B, T, D)
        o = _attention(q, k, v, kmask, h).reshape(B * T, D)
        xr = xr + _mm(o, lins[3])
        xn = _ln(xr, layer.sublayer[1].norm)
        mid = torch.relu(_mm(xn, layer.feed_forward.w_1)).to(BF16)
        xr = xr + _mm(mid, layer.feed_forward.w_2)
    return _ln(xr, enc.norm).view(B, T, D)


def _err(a, ref, rows=None):
    d = (a.double() - ref).abs()
    return (d if rows is None else d[rows]).max().item()


@pytest.mark.parametrize("T", [1, 137, 160, 300])
@pytest.mark.parametrize("d_k", [16, 32])
def test_blockwise_emulation_within_bound_of_plain_and_pallas(d_k, T):
    D = H * d_k
    params, enc, x, mask = _case(1000 * d_k + T, D, T)
    assert enc_k.kernel_path(BF16, d_k, D, F) == enc_k.PATH_WGMMA
    xb, mb = torch.from_numpy(x).to(BF16), torch.from_numpy(mask)
    with torch.no_grad():
        got = _blockwise(enc, xb, mb)
        ref = enc_k.encoder_stack_fused_plain(copy.deepcopy(enc).double(),
                                              xb.double(), mb.double(), h=H)
        plain = enc_k.encoder_stack_fused_plain(enc, xb, mb.to(BF16), h=H)
    assert got.dtype == BF16 and torch.isfinite(got.float()).all()
    err, plain_err = _err(got, ref), _err(plain, ref)
    assert err <= 2 * plain_err + 1e-6, (err, plain_err)

    pallas = np.asarray(jenc.encoder_stack_fused(
        params, jnp.asarray(x, jnp.bfloat16), jnp.asarray(mask), h=H,
        interpret=True).astype(jnp.float32))
    valid = torch.from_numpy(mask[..., 0] > 0)
    err = _err(got, ref, valid)
    pallas_err = _err(torch.from_numpy(pallas), ref, valid)
    assert err <= 2 * pallas_err + 1e-6, (err, pallas_err)


def test_attention_emulation_of_a_video_with_no_key_is_the_mean_of_v():
    rs = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rs.randn(2, 300, 64).astype(np.float32))
               .to(BF16) for _ in range(3))
    kmask = torch.zeros(2, 300)
    kmask[1, :5] = 1.0
    got = _attention(q, k, v, kmask, 2)[0].double()
    want = v[0].double().mean(dim=0, keepdim=True).expand_as(got)
    # every score and the max are -1e9, so every key of both tiles gets one
    # p = 2^r (r the float32 rounding of -1e9 log2 e, |r| <= 64); p rounded
    # to bf16 for p.v and not in the sum scales the mean by 1 +- 2^-8 (bf16's
    # unit roundoff), and the output's rounding adds 2^-8 of it
    assert ((got - want).abs() <= 2.0 ** -7 * want.abs() + 1e-6).all()


@pytest.mark.parametrize("dtype,d_k,D,F_,path", [
    (torch.bfloat16, 32, 256, 128, enc_k.PATH_WGMMA),
    (torch.bfloat16, 16, 128, 128, enc_k.PATH_WGMMA),
    (torch.bfloat16, 32, 256, 256, enc_k.PATH_FMA),
    (torch.bfloat16, 16, 256, 128, enc_k.PATH_WGMMA),
    (torch.bfloat16, 2, 16, 128, enc_k.PATH_FMA),
    (torch.bfloat16, 8, 64, 128, enc_k.PATH_FMA),
    (torch.bfloat16, 16, 64, 32, enc_k.PATH_FMA),
    (torch.bfloat16, 32, 256, 64, enc_k.PATH_FMA),
    (torch.float32, 32, 256, 128, enc_k.PATH_FMA),
    (torch.float32, 16, 128, 128, enc_k.PATH_FMA)])
def test_kernel_path_of_dtype_d_k_and_widths(dtype, d_k, D, F_, path):
    assert enc_k.kernel_path(dtype, d_k, D, F_) == path


@pytest.mark.parametrize("dtype,d_k,error", [
    (torch.bfloat16, 12, ValueError), (torch.float32, 64, ValueError),
    (torch.float16, 32, TypeError), (torch.float64, 16, TypeError)])
def test_kernel_path_refuses_what_no_path_takes(dtype, d_k, error):
    with pytest.raises(error):
        enc_k.kernel_path(dtype, d_k, 8 * d_k, 128)


def test_key_tiles_cover_the_row_with_no_empty_tile():
    assert [enc_k.key_tiles(T) for T in (1, 64, 65, 160, 256, 257, 512,
                                         544)] == \
        [(1, 64), (1, 64), (1, 128), (1, 192), (1, 256), (2, 192), (2, 256),
         (3, 192)]
    for T in range(1, 2049):
        tiles, keys = enc_k.key_tiles(T)
        assert keys % 64 == 0 and keys <= 256
        assert (tiles - 1) * keys < T <= tiles * keys
        if T <= 256:
            assert tiles == 1
    with pytest.raises(ValueError):
        enc_k.key_tiles(0)


@pytest.mark.parametrize("d_k,t_max", [(32, 1536), (16, 3328)])
def test_attention_fit_and_its_refusal(d_k, t_max):
    enc_k.check_attention_fit(t_max, d_k)
    assert enc_k.attention_smem_bytes(t_max, d_k) <= enc_k.SMEM_LIMIT
    with pytest.raises(ValueError, match=f"T={t_max + 1}, d_k={d_k}"):
        enc_k.check_attention_fit(t_max + 1, d_k)


def test_wrapper_refuses_a_t_past_the_fit_before_any_build(monkeypatch):
    """A bf16 stack on the wgmma path whose K and V would not fit raises
    (routed as if on the card; the check comes before the library loads)."""
    from multimodal_transformer_tpu_torch.ops.cuda import _build
    monkeypatch.setattr(enc_k, "use_kernel", lambda t: True)
    monkeypatch.setattr(_build, "load", lambda *a, **k: pytest.fail("built"))
    enc = Encoder(256, F, 1).to(BF16)
    x = torch.zeros(1, 1537, 256, dtype=BF16)
    with torch.no_grad(), pytest.raises(ValueError, match="shared memory"):
        enc_k.encoder_stack_fused(enc, x, torch.ones(1, 1537, 1, dtype=BF16))
