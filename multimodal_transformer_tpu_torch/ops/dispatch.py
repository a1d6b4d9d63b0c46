"""Kernel dispatch: one rule, no knobs.

A tensor on a CUDA device goes to the hand-written kernel; a tensor on the
CPU goes to the kernel's plain PyTorch version.  The wrappers apply it, and a
CUDA call that the kernel cannot take raises instead of falling back.
"""

from __future__ import annotations

import torch


def use_kernel(x: torch.Tensor) -> bool:
    return x.is_cuda


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
