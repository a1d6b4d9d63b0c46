"""Kernel dispatch: one rule for the device, one shape rule for the encoder,
no knobs.

A tensor on a CUDA device goes to the hand-written kernel; a tensor on the
CPU goes to the kernel's plain PyTorch version.  The wrappers apply it, and a
CUDA call that the kernel cannot take raises instead of falling back.

The encoder stack takes one of five routes (`encoder_route`), as the JAX
package's `ops/attention.py` routes it on the TPU:
  * "fused": kernel A (ops/cuda/encoder.py), eval in "key_query" mode at
    T <= FLASH_ATTN_MIN_T;
  * "flash": layer by layer with attention through kernel 11
    (ops/cuda/flash_attention.py), eval in "key_query" mode at longer T;
  * "train": kernels 3 and 4 (ops/cuda/encoder_train.py), training with
    dropout seeds in "key_query" mode, at every T, and any call that needs
    gradients without seeds, at p = 0 (kernel A has no backward);
  * "train_stack": the same with kernel 5 for the backward, one call per
    stack; the caller asks for it with backward="stack" (the JAX package's
    opt-in MMTX_ENC_BWD=stack, an argument here rather than a variable);
  * "plain": the plain encoder, for a CPU tensor, "query" mode or no mask,
    and for training on the "threefry" dropout (threefry keys in place of
    hash seeds: the JAX package keeps that stream off its kernels, whose
    masks are the hash's).
"""

from __future__ import annotations

import torch

# The JAX package's flash gate (`FLASH_ATTN_MIN_T`, ops/dispatch.py there):
# flash attention serves T >= 512 once its fused encoder kernel declines,
# and that kernel's eval fit (`fused_encoder_fits`, which pads T to a
# multiple of 8) admits T <= 512 at D = 256.  At T = 512 the fused kernel
# goes first, so the flash route starts past it.
FLASH_ATTN_MIN_T = 512


def use_kernel(x: torch.Tensor) -> bool:
    return x.is_cuda


ENCODER_BACKWARDS = ("perlayer", "stack")


def check_encoder_backward(backward: str) -> str:
    if backward not in ENCODER_BACKWARDS:
        raise ValueError(f"encoder_backward must be one of "
                         f"{ENCODER_BACKWARDS}, got {backward!r}")
    return backward


def encoder_route(on_card: bool, T: int, mask_mode: str, training: bool,
                  backward: str = "perlayer", needs_grad: bool = False,
                  threefry: bool = False) -> str:
    """The route of an encoder stack over T steps: on_card is whether its
    input is on a CUDA device and masked; training whether it carries
    dropout seeds; backward the training backward, "perlayer" (kernel 4 per
    layer, the JAX package's default) or "stack" (kernel 5); needs_grad
    whether autograd wants gradients of the call.  Training keeps the
    kernels at every T: the JAX package trains past T = 256 through jnp
    instead, with the same dropout masks, so only the route differs (ROADMAP
    Queue 3).  A call that needs gradients without seeds takes the training
    route too, at p = 0, as the JAX package differentiates `apply(rng=None)`
    through its trainable kernels.  threefry: the training seeds are
    threefry keys, which only the plain encoder takes."""
    check_encoder_backward(backward)
    if not on_card or mask_mode != "key_query" or (training and threefry):
        return "plain"
    if training or needs_grad:
        return "train_stack" if backward == "stack" else "train"
    return "flash" if T > FLASH_ATTN_MIN_T else "fused"


def needs_grad(*tensors) -> bool:
    """Whether autograd records a call on these tensors: grad mode is on and
    one of them requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def check_no_grad(what: str, *tensors) -> None:
    """Raises if autograd would record a call on these tensors: the eval
    kernels write their outputs through ctypes, with no backward, so their
    outputs would silently carry no gradient."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{what}: the eval kernel has no backward, and an input or "
            "parameter requires grad; run it under torch.no_grad() or "
            "torch.inference_mode(), or differentiate through the training "
            "route")


def check_kernel_dtype(x: torch.Tensor, what: str) -> int:
    """The kernels' dtype code (0 fp32, 1 bf16); raises for anything else."""
    if x.dtype == torch.float32:
        return 0
    if x.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"{what}: the CUDA kernel takes float32 or bfloat16, "
                    f"got {x.dtype}")


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The accumulation dtype of the plain versions: float64 for float64
    inputs (the reference for error bounds), float32 otherwise."""
    return torch.float64 if dtype == torch.float64 else torch.float32
