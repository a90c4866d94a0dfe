"""Numerics: log-cosh, the batched machine engine, RNG helpers and the CUDA
kernels (``sweep``, ``energy``) with their plain PyTorch versions."""
