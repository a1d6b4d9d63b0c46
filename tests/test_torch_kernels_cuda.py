"""The CUDA kernels against their plain versions on the card (the kernel
phases of chip_smoke.py): kernel A at B=32, T in {160, 137, 544} (its bf16
wgmma path also at d_k = 16, at B=1, T in {37, 1} and at two online key
tiles, its bf16 FMA path at D = 16, d_k = 2, each bit-identical when
called again), kernel B at
B=32, T=160 A+V+L, B=2, T=1,120, B=1, T=37, a ragged case and the emotient
modality (bit-identical when called again), kernel 10 (window embed) at the front end's four shapes
and its autograd Function's gradients, kernel 11 (flash attention) at the
long-video buckets' shapes (B*h = 32*8, T in {544, 640, 1024, 1120}, d_k =
32, and T = 544, d_k = 16) and ragged cases (T = 601, d_k = 32 and d_k = 2,
videos with no key), its TMA + wgmma path (bf16, d_k in {16, 32}) at T in
{137, 544, 601, 1024, 1120} with videos with no key and on one-hot q and k
whose output is known exactly, and its Function's gradients on both d_k,
and the five training kernels (encoder stack forward, layer backward and
whole-stack backward, MFN forward and reverse recurrence) at
B=32, T in {160, 400}, fp32 and bf16 (the encoder backward's bf16 wgmma
path also at d_k in {16, 32}, T in {1, 137, 160, 400}, p in {0.1, 0},
its bf16 FMA path at D = 16, d_k = 2, p in {0.1, 0}, both bit-identical
when called again), within the competitive bound
err(kernel - fp64 plain) <= 2 * err(plain - fp64 plain) + 1e-6 on every
output tensor, the whole-stack backward also bit-identical to the layer
backward called per layer, and the training kernels again at p = 0; the
MFN's packed and aligned variants (rows 8 and 9) at the main path's shape,
a ragged one and one with the emotient modality; and the routes: kernel A
up to T = 512, kernel 11 layer by layer past it, the plain encoder in
"query" mode, kernel 5 in place of kernel 4 on the "stack" training route,
kernels 3/4 and 6/7 at p = 0 for gradients without seeds.

Needs an NVIDIA GPU and nvcc; skips without them.  On the card, where JAX
(which tests/conftest.py sets up) is not installed:
    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
"""

import pytest
import torch

pytestmark = pytest.mark.cuda

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; chip_smoke.py "
                    "covers the same checks)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("T", [160, 137, 544])
def test_encoder_kernel_within_bound(device, T, dtype):
    from multimodal_transformer_tpu_torch.ops.cuda import encoder, verify
    before = encoder.launches
    c = verify.check_encoder(32, T, DTYPES[dtype], device=device, reps=1)
    assert encoder.launches > before
    assert c.ok, c.line()


@pytest.mark.parametrize("B,T,D", [(32, 160, 256), (32, 160, 128),
                                   (1, 37, 256), (1, 1, 256), (3, 300, 256)])
def test_encoder_wgmma_path_within_bound_and_bit_identical(device, B, T, D):
    """Kernel A's bf16 wgmma path at d_k = D / 8 in {32, 16}, one video at
    T = 37 and T = 1, and two online key tiles (T = 300)."""
    from multimodal_transformer_tpu_torch.ops.cuda import encoder, verify
    assert encoder.kernel_path(torch.bfloat16, D // 8, D, 128) == \
        encoder.PATH_WGMMA
    c = verify.check_encoder(B, T, torch.bfloat16, device=device, D=D, reps=1,
                             repeat=True)
    assert c.identical and c.ok, c.line()


def test_encoder_bf16_fma_path_within_bound_and_bit_identical(device):
    """Kernel A's bf16 FMA path at the emotient encoder's D = 16 (d_k = 2)."""
    from multimodal_transformer_tpu_torch.ops.cuda import encoder, verify
    assert encoder.kernel_path(torch.bfloat16, 2, 16, 128) == encoder.PATH_FMA
    c = verify.check_encoder(32, 160, torch.bfloat16, device=device, D=16,
                             reps=1, repeat=True)
    assert c.identical and c.ok, c.line()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mfn_kernel_within_bound(device, dtype):
    from multimodal_transformer_tpu_torch.ops.cuda import mfn, verify
    before = mfn.launches
    c = verify.check_mfn(32, 160, DTYPES[dtype], device=device, reps=1)
    assert mfn.launches > before
    assert c.ok and c.identical, c.line()


# kernel B off the main path's shape: (B, T, modalities) of a long-video
# bucket, one video (evaluate_per_video), a ragged case and the emotient
# modality (H = 16)
MFN_B_SHAPES = {"T1120": (2, 1120, ("acoustic", "image", "linguistic")),
                "B1": (1, 37, ("acoustic", "image", "linguistic")),
                "ragged": (3, 7, ("linguistic", "acoustic")),
                "emotient": (4, 9, ("emotient", "acoustic"))}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", sorted(MFN_B_SHAPES))
def test_mfn_kernel_shapes_within_bound(device, shape, dtype):
    """Within the bound and bit-identical when called again."""
    from multimodal_transformer_tpu_torch.ops.cuda import mfn, verify
    B, T, mods = MFN_B_SHAPES[shape]
    before = mfn.launches
    c = verify.check_mfn(B, T, DTYPES[dtype], device=device, mods=mods,
                         reps=0)
    assert mfn.launches == before + 2
    assert c.ok and c.identical, c.line()


# kernel -> (wrapper module, launch counter, verify check)
TRAIN_KERNELS = {"encoder_stack_train_fwd": ("encoder_train", "fwd_launches",
                                             "check_encoder_train_fwd"),
                 "encoder_layer_bwd": ("encoder_train", "bwd_launches",
                                       "check_encoder_layer_bwd"),
                 "encoder_stack_bwd": ("encoder_train", "stack_bwd_launches",
                                       "check_encoder_stack_bwd"),
                 "mfn_train_fwd": ("mfn_train", "fwd_launches",
                                   "check_mfn_train_fwd"),
                 "mfn_train_bwd": ("mfn_train", "bwd_launches",
                                   "check_mfn_train_bwd")}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("T", [160, 400])
@pytest.mark.parametrize("kernel", sorted(TRAIN_KERNELS))
def test_train_kernel_within_bound(device, kernel, T, dtype):
    import importlib

    from multimodal_transformer_tpu_torch.ops.cuda import verify
    module, counter, check = TRAIN_KERNELS[kernel]
    mod = importlib.import_module(
        f"multimodal_transformer_tpu_torch.ops.cuda.{module}")
    before = getattr(mod, counter)
    c = getattr(verify, check)(32, T, DTYPES[dtype], device=device, reps=0)
    assert getattr(mod, counter) > before
    assert c.ok, c.line()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kernel", sorted(TRAIN_KERNELS))
def test_train_kernel_at_p0_within_bound(device, kernel, dtype):
    """The dropout-free training route's kernels: the same checks at p = 0
    (keep threshold 0, keep scale 1)."""
    from multimodal_transformer_tpu_torch.ops.cuda import verify
    _, _, check = TRAIN_KERNELS[kernel]
    c = getattr(verify, check)(32, 160, DTYPES[dtype], device=device, reps=0,
                               p=0.0)
    assert c.ok, c.line()


@pytest.mark.parametrize("p", [0.1, 0.0])
@pytest.mark.parametrize("T", [1, 137, 160, 400])
@pytest.mark.parametrize("d_k", [16, 32])
@pytest.mark.parametrize("kernel", ["encoder_layer_bwd", "encoder_stack_bwd"])
def test_encoder_bwd_wgmma_path_within_bound_and_bit_identical(device, kernel,
                                                               d_k, T, p):
    """Kernels 4 and 5's bf16 wgmma path at d_k = 16 (D = 128) and 32 (D =
    256), one key to seven key tiles, both dropout rates: within the bound,
    bit-identical when called again, and kernel 5 bit-identical to kernel 4
    called for every layer."""
    from multimodal_transformer_tpu_torch.ops.cuda import encoder, verify
    D = 8 * d_k
    assert encoder.kernel_path(torch.bfloat16, d_k, D, 128) == \
        encoder.PATH_WGMMA
    _, _, check = TRAIN_KERNELS[kernel]
    c = getattr(verify, check)(32, T, torch.bfloat16, device=device, reps=0,
                               p=p, D=D, repeat=True)
    assert c.identical and c.ok, c.line()


@pytest.mark.parametrize("p", [0.1, 0.0])
@pytest.mark.parametrize("kernel", ["encoder_layer_bwd", "encoder_stack_bwd"])
def test_encoder_bwd_fma_path_bf16_within_bound(device, kernel, p):
    """Kernels 4 and 5's bf16 FMA path (the emotient encoder's widths: D =
    16, h = 8, d_k = 2) against the plain backward at its bf16 rounding
    points: within the bound and bit-identical when called again."""
    from multimodal_transformer_tpu_torch.ops.cuda import encoder, verify
    assert encoder.kernel_path(torch.bfloat16, 2, 16, 128) == \
        encoder.PATH_FMA
    _, _, check = TRAIN_KERNELS[kernel]
    c = getattr(verify, check)(32, 160, torch.bfloat16, device=device,
                               reps=0, p=p, D=16, repeat=True)
    assert c.identical and c.ok, c.line()


# the MFN variants (rows 8 and 9): (B, T, modalities) at the main path's
# shape, a ragged one and one with the emotient modality (H = 16)
MFN_VARIANT_SHAPES = {
    "main": (32, 160, ("acoustic", "image", "linguistic")),
    "ragged": (3, 7, ("linguistic", "acoustic")),
    "emotient": (4, 9, ("emotient", "acoustic"))}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", sorted(MFN_VARIANT_SHAPES))
@pytest.mark.parametrize("variant", ["packed", "aligned"])
def test_mfn_variant_kernel_within_bound(device, variant, shape, dtype):
    from multimodal_transformer_tpu_torch.ops.cuda import (mfn, mfn_variants,
                                                           verify)
    counter = f"{variant}_launches"
    before = (getattr(mfn_variants, counter), mfn.launches)
    B, T, mods = MFN_VARIANT_SHAPES[shape]
    c = getattr(verify, f"check_mfn_{variant}")(B, T, DTYPES[dtype],
                                                device=device, mods=mods,
                                                reps=0)
    assert getattr(mfn_variants, counter) > before[0]
    assert mfn.launches == before[1]
    assert c.ok, c.line()


def test_mfn_variants_raise_on_what_they_do_not_take(device):
    from multimodal_transformer_tpu_torch.ops.cuda import mfn_variants
    from multimodal_transformer_tpu_torch.ops.mfn_core import (MFN,
                                                               hoisted_inputs)
    mfn = MFN(("acoustic", "linguistic"), {"acoustic": 8, "linguistic": 8},
              1).to(device)
    whhs = [mfn.lstm_acoustic.weight_hh, mfn.lstm_linguistic.weight_hh]
    with torch.no_grad():
        xps = hoisted_inputs(mfn, {m: torch.randn(2, 5, 8, device=device)
                                   for m in mfn.mods})
        for scan in (mfn_variants.mfn_scan_packed,
                     mfn_variants.mfn_scan_aligned):
            with pytest.raises(ValueError):
                scan(xps[:1], whhs, mfn.gate_tensors())
            with pytest.raises(TypeError):
                scan([x.half() for x in xps], whhs, mfn.gate_tensors())
    xps = hoisted_inputs(mfn, {m: torch.randn(2, 5, 8, device=device)
                               for m in mfn.mods})
    for scan in (mfn_variants.mfn_scan_packed, mfn_variants.mfn_scan_aligned):
        with pytest.raises(RuntimeError, match="no backward"):
            scan(xps, whhs, mfn.gate_tensors())


def _within_train_limits(got, want) -> bool:
    """chip_smoke.py's train limits: each gradient within 1e-3 of its own
    L2 norm plus 1e-6 of the whole gradient's (the k-projection biases'
    gradients are mathematically zero, rounding noise on both paths)."""
    total = torch.sqrt(sum((b.double() ** 2).sum() for b in want))
    return all((a - b).double().norm() <= 1e-3 * b.double().norm()
               + 1e-6 * total for a, b in zip(got, want))


def test_dropout_free_gradients_take_the_training_kernels(device):
    """Without seeds and with gradients needed, the encoder takes kernels 3
    and 4 at p = 0 and the MFN kernels 6 and 7, never kernel A or B; the
    gradients agree with autograd through the plain path; kernels A and B
    called directly under autograd raise."""
    from multimodal_transformer_tpu_torch.ops import mfn_core
    from multimodal_transformer_tpu_torch.ops.attention import (
        encoder_stack, encoder_stack_plain)
    from multimodal_transformer_tpu_torch.ops.cuda import (encoder,
                                                           encoder_train, mfn,
                                                           mfn_train, verify)
    gen = torch.Generator().manual_seed(5)
    enc = verify.random_encoder(gen).to(device)
    x = torch.randn(4, 40, 256, generator=gen).to(device).requires_grad_()
    mask = torch.ones(4, 40, 1, device=device)
    mask[1, 25:] = 0
    g = torch.randn(4, 40, 256, generator=gen).to(device) * mask
    leaves = [x] + list(enc.parameters())
    for counter in (encoder, encoder_train, mfn, mfn_train):
        counter.reset_launches()
    got = torch.autograd.grad(encoder_stack(enc, x, mask,
                                            mask_mode="key_query"), leaves, g)
    want = torch.autograd.grad(encoder_stack_plain(enc, x, mask,
                                                   mask_mode="key_query"),
                               leaves, g)
    assert (encoder.launches, encoder_train.fwd_launches,
            encoder_train.bwd_launches) == (0, 1, 6)
    assert _within_train_limits(got, want)
    with pytest.raises(RuntimeError, match="no backward"):
        encoder.encoder_stack_fused(enc, x, mask)

    m = mfn_core.MFN(("acoustic", "image", "linguistic"),
                     {k: 16 for k in ("acoustic", "image", "linguistic")}, 1,
                     gen=gen).to(device)
    inputs = {k: torch.randn(4, 12, 16, generator=gen).to(device)
              for k in m.mods}
    got = torch.autograd.grad(mfn_core.mfn_scan(m, inputs).sum(),
                              list(m.parameters()))
    want = torch.autograd.grad(mfn_core.mfn_scan(m, inputs, plain=True).sum(),
                               list(m.parameters()))
    assert (mfn.launches, mfn_train.fwd_launches,
            mfn_train.bwd_launches) == (0, 1, 1)
    assert _within_train_limits(got, want)
    with pytest.raises(RuntimeError, match="no backward"):
        mfn.mfn_scan_fused(mfn_core.hoisted_inputs(m, inputs),
                           [getattr(m, f"lstm_{k}").weight_hh for k in m.mods],
                           m.gate_tensors())


# (frames, mod dim, window embed) of the front end's shapes at B=32, T=160
# (B, T, frames, mod dim, window embed); "ragged": windows longer than one
# 128-row tile and an odd mod dim
WINDOW_EMBED_SHAPES = {"acoustic_mft": (32, 160, 4, 88, 88),
                       "acoustic_sft": (32, 160, 4, 88, 256),
                       "image": (32, 160, 4, 1000, 256),
                       "linguistic": (32, 160, 32, 300, 300),
                       "ragged": (3, 7, 200, 33, 45)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", sorted(WINDOW_EMBED_SHAPES))
def test_window_embed_kernel_within_bound(device, shape, dtype):
    from multimodal_transformer_tpu_torch.ops.cuda import verify, window_embed
    before = window_embed.launches
    c = verify.check_window_embed(*WINDOW_EMBED_SHAPES[shape], DTYPES[dtype],
                                  device=device, reps=0)
    assert window_embed.launches > before
    assert c.ok, c.line()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_window_embed_function_grads_within_bound(device, dtype):
    from multimodal_transformer_tpu_torch.ops.cuda import verify
    c = verify.check_window_embed_grad(4, 20, 32, 300, 300, DTYPES[dtype],
                                       device=device)
    assert c.ok, c.line()


# (B, h, T, d_k, videos with every key masked) of kernel 11: the long-video
# buckets at D = 256 up to 1,120, ragged T with d_k = 32 and d_k = 2 (the
# emotient encoder), and d_k = 16
FLASH_SHAPES = {"T544": (32, 8, 544, 32, 0), "T640": (32, 8, 640, 32, 0),
                "T1024": (32, 8, 1024, 32, 0), "ragged_dk2": (5, 8, 601, 2, 2),
                "T1120": (32, 8, 1120, 32, 0),
                "ragged_dk32": (32, 8, 601, 32, 2),
                "T544_dk16": (32, 8, 544, 16, 0)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", sorted(FLASH_SHAPES))
def test_flash_attention_kernel_within_bound(device, shape, dtype):
    from multimodal_transformer_tpu_torch.ops.cuda import (flash_attention,
                                                           verify)
    B, h, T, d_k, all_masked = FLASH_SHAPES[shape]
    before = flash_attention.launches
    c = verify.check_flash_attention(B, h, T, d_k, DTYPES[dtype],
                                     device=device, all_masked=all_masked,
                                     reps=0)
    assert flash_attention.launches > before
    assert c.ok, c.line()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_attention_function_grads_within_bound(device, dtype):
    from multimodal_transformer_tpu_torch.ops.cuda import verify
    c = verify.check_flash_attention_grad(4, 8, 544, 32, DTYPES[dtype],
                                          device=device)
    assert c.ok, c.line()


@pytest.mark.parametrize("d_k", [16, 32])
@pytest.mark.parametrize("T", [137, 544, 601, 1024, 1120])
def test_flash_attention_wgmma_path_within_bound(device, T, d_k):
    """bf16 at d_k in {16, 32} takes the TMA + wgmma path: ragged key tiles,
    query tiles past Tq and two videos with no key."""
    from multimodal_transformer_tpu_torch.ops.cuda import (flash_attention,
                                                           verify)
    assert flash_attention.kernel_path(torch.bfloat16, d_k) == \
        flash_attention.PATH_WGMMA
    before = flash_attention.launches
    c = verify.check_flash_attention(32, 8, T, d_k, torch.bfloat16,
                                     device=device, all_masked=2, reps=0)
    assert flash_attention.launches == before + 1
    assert c.ok, c.line()


@pytest.mark.parametrize("d_k", [16, 32])
def test_flash_attention_wgmma_path_on_one_hot_keys(device, d_k):
    """A closed form that names what a wrong TMA box or wgmma descriptor
    would move: q[i] = 256 e_(i mod d_k) and k[j] = e_(j mod d_k), so query
    i attends (to e^-45 of the rest) to the keys j = i mod d_k, and
    v[j, d] = d_k (j mod 256/d_k) + d, exact in bf16, is the same on all of
    them: out[i] = v[i] up to the other keys' weight (< T 255 e^-45, ~1e-15;
    1e-6 here), where a wrong key or column is off by 1 or more.  A wrong
    key decodes as out // d_k, a wrong column (a 16-byte chunk) as
    out mod d_k.  The second video has no key (the uniform mean of v), held
    to the competitive bound."""
    from multimodal_transformer_tpu_torch.ops.cuda import flash_attention
    B, h, T = 2, 8, 601
    idx = torch.arange(T)
    eye = torch.eye(d_k)
    v1 = (d_k * (idx % (256 // d_k)))[:, None] + torch.arange(d_k)[None, :]
    heads = lambda t: t.float().expand(B * h, T, d_k).contiguous().to(
        device=device, dtype=torch.bfloat16)
    q, k, v = heads(256.0 * eye[idx % d_k]), heads(eye[idx % d_k]), heads(v1)
    kmask = torch.ones(B, T, device=device)
    kmask[1] = 0
    out = flash_attention.flash_attention_masked(q, k, v, kmask, h).float()
    torch.cuda.synchronize()
    got, want = out[:h].cpu(), v1.float().expand(h, T, d_k)
    bad = ((got - want).abs() > 1e-6).nonzero().tolist()
    assert not bad, "first wrong (head, row, column): got key class, " \
        "column: " + "; ".join(
            f"{b, i, d}: {round(got[b, i, d].item()) // d_k}, "
            f"{round(got[b, i, d].item()) % d_k}"
            f" (want {i % (256 // d_k)}, {d})" for b, i, d in bad[:8])
    ref = flash_attention.flash_attention_masked_plain(
        q.double(), k.double(), v.double(), kmask, h)[h:]
    plain = flash_attention.flash_attention_masked_plain(q, k, v, kmask, h)
    err = (out[h:] - ref).abs().max().item()
    plain_err = (plain[h:].double() - ref).abs().max().item()
    assert err <= 2 * plain_err + 1e-6, (err, plain_err)


def test_flash_attention_function_grads_on_d_k_16_within_bound(device):
    from multimodal_transformer_tpu_torch.ops.cuda import verify
    c = verify.check_flash_attention_grad(4, 8, 601, 16, torch.bfloat16,
                                          device=device)
    assert c.ok, c.line()


def test_flash_attention_raises_on_what_it_does_not_take(device):
    from multimodal_transformer_tpu_torch.ops.cuda import flash_attention
    q = torch.randn(8, 520, 12, device=device)  # d_k 12: no kernel
    with pytest.raises(ValueError):
        flash_attention.flash_attention_masked(q, q, q,
                                               torch.ones(1, 520,
                                                          device=device), 8)
    q = torch.randn(8, 520, 32, device=device, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention.flash_attention_masked(q, q, q,
                                               torch.ones(1, 520,
                                                          device=device), 8)


def test_long_videos_take_the_flash_route_on_cuda(device):
    from multimodal_transformer_tpu_torch.ops.attention import (
        encoder_stack, encoder_stack_plain)
    from multimodal_transformer_tpu_torch.ops.cuda import (encoder,
                                                           flash_attention,
                                                           verify)
    enc = verify.random_encoder(torch.Generator().manual_seed(0)).to(device)
    for T, flash, fused in ((512, 0, 1), (513, 6, 0)):
        x = torch.randn(2, T, 256, device=device)
        mask = torch.ones(2, T, 1, device=device)
        mask[1, T // 2:] = 0
        f0, e0 = flash_attention.launches, encoder.launches
        with torch.inference_mode():
            got = encoder_stack(enc, x, mask, mask_mode="key_query")
            want = encoder_stack_plain(enc, x, mask, mask_mode="key_query")
        assert (flash_attention.launches - f0, encoder.launches - e0) == \
            (flash, fused)
        valid = mask[..., 0].bool()
        assert (got - want)[valid].abs().max().item() < 1e-4


def test_query_mode_takes_the_plain_encoder_on_cuda(device):
    from multimodal_transformer_tpu_torch.ops.attention import (
        Encoder, encoder_stack, encoder_stack_plain)
    from multimodal_transformer_tpu_torch.ops.cuda import encoder
    enc = Encoder(256, 128, 1).to(device)
    x = torch.randn(2, 8, 256, device=device)
    mask = torch.ones(2, 8, 1, device=device)
    before = encoder.launches
    got = encoder_stack(enc, x, mask, mask_mode="query")
    assert encoder.launches == before
    assert torch.equal(got, encoder_stack_plain(enc, x, mask,
                                                mask_mode="query"))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_stack_route_takes_kernel_5_bit_identical_to_kernel_4(device, dtype):
    """One training forward and backward of an encoder on each route:
    "stack" launches kernel 5 once and kernel 4 never, and every gradient
    equals the "perlayer" route's bit for bit."""
    from multimodal_transformer_tpu_torch.ops.attention import encoder_stack
    from multimodal_transformer_tpu_torch.ops.cuda import (encoder_train,
                                                           verify)
    gen = torch.Generator().manual_seed(3)
    enc = verify.random_encoder(gen).to(device=device, dtype=DTYPES[dtype])
    x = torch.randn(4, 40, 256, generator=gen).to(device, DTYPES[dtype])
    mask = torch.ones(4, 40, 1, device=device, dtype=DTYPES[dtype])
    mask[1, 25:] = 0
    seeds = verify.random_seeds(gen, 6, 4)
    g = torch.randn(4, 40, 256, generator=gen).to(device, DTYPES[dtype])
    grads = {}
    for backward in ("perlayer", "stack"):
        xx = x.clone().requires_grad_()
        encoder_train.reset_launches()
        y = encoder_stack(enc, xx, mask, mask_mode="key_query", seeds=seeds,
                          backward=backward)
        params = [xx] + list(enc.parameters())
        grads[backward] = torch.autograd.grad(y, params, g)
        counts = (encoder_train.fwd_launches, encoder_train.bwd_launches,
                  encoder_train.stack_bwd_launches)
        assert counts == ((1, 6, 0) if backward == "perlayer" else (1, 0, 1))
    for a, b in zip(grads["perlayer"], grads["stack"]):
        assert torch.equal(a, b)
