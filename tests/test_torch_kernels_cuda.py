"""The CUDA kernels against their plain versions on the card (the kernel
phases of chip_smoke.py): kernel A at B=32, T in {160, 137, 544}, kernel B at
B=32, T=160 A+V+L, kernel 10 (window embed) at the front end's four shapes
and its autograd Function's gradients, and the four training kernels
(encoder stack forward and layer backward, MFN forward and reverse
recurrence) at B=32, T in {160, 400}, fp32 and bf16, within the competitive
bound
err(kernel - fp64 plain) <= 2 * err(plain - fp64 plain) + 1e-6 on every
output tensor.

Needs an NVIDIA GPU and nvcc; skips without them.  On the card:
    python -m pytest tests/test_torch_kernels_cuda.py -q
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


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mfn_kernel_within_bound(device, dtype):
    from multimodal_transformer_tpu_torch.ops.cuda import mfn, verify
    before = mfn.launches
    c = verify.check_mfn(32, 160, DTYPES[dtype], device=device, reps=1)
    assert mfn.launches > before
    assert c.ok, c.line()


TRAIN_KERNELS = {"encoder_stack_train_fwd": ("encoder_train", "fwd_launches"),
                 "encoder_layer_bwd": ("encoder_train", "bwd_launches"),
                 "mfn_train_fwd": ("mfn_train", "fwd_launches"),
                 "mfn_train_bwd": ("mfn_train", "bwd_launches")}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("T", [160, 400])
@pytest.mark.parametrize("kernel", sorted(TRAIN_KERNELS))
def test_train_kernel_within_bound(device, kernel, T, dtype):
    import importlib

    from multimodal_transformer_tpu_torch.ops.cuda import verify
    module, counter = TRAIN_KERNELS[kernel]
    mod = importlib.import_module(
        f"multimodal_transformer_tpu_torch.ops.cuda.{module}")
    before = getattr(mod, counter)
    c = getattr(verify, f"check_{kernel}")(32, T, DTYPES[dtype],
                                           device=device, reps=0)
    assert getattr(mod, counter) > before
    assert c.ok, c.line()


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
