"""Numerics: log-cosh, the batched machine engine, RNG helpers and the CUDA
kernels (``sweep``, ``energy``, ``exchange``) with their plain PyTorch versions."""
