"""Wrappers of the hand-written CUDA kernels (sources in ../../csrc).

Each wrapper launches its kernel for a CUDA tensor, runs its plain PyTorch
version for a CPU tensor, and counts its launches in `launches`."""
