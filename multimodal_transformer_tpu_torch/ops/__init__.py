"""Numerics of the port: plain PyTorch ops and the CUDA kernel wrappers."""
