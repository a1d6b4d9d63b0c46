"""PyTorch/CUDA port of multimodal_transformer_tpu for NVIDIA Hopper.

The JAX package `multimodal_transformer_tpu` is the reference; this package
mirrors its layout.  It imports torch and never jax.  Importing it builds no
kernel: the CUDA kernels in `csrc/` are compiled with nvcc at first use
(ops/cuda/_build.py), and only for tensors on a CUDA device.
"""

from .models import ModelConfig, build_model, default_config, modalities_from_comb
from .serve import ValencePredictor

__all__ = ["ModelConfig", "ValencePredictor", "build_model", "default_config",
           "modalities_from_comb"]
