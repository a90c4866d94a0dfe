"""PyTorch/CUDA port of neural_network_quantum_state_tpu.

Same module layout and names as the JAX package. Plain tensor code is
PyTorch; the TPU kernels on the ported path are CUDA kernels for Hopper
(``csrc/``), each with a plain PyTorch version that runs on the CPU. Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``. The
subpackages are exported as the JAX package exports its own, and
``drivers``, the CLI; ``pynqs`` is the reference's sampler API under its
name (``api``).
"""

from neural_network_quantum_state_tpu_torch.vmc import VMC, VMCConfig

from neural_network_quantum_state_tpu_torch import (  # noqa: E402  (after VMC: the drivers reach nqs.VMC)
    api,
    drivers,
    hamiltonians,
    measurements,
    models,
    ops,
    optim,
    parallel,
    sampler,
    utils,
)

__all__ = [
    "VMC",
    "VMCConfig",
    "api",
    "drivers",
    "hamiltonians",
    "measurements",
    "models",
    "ops",
    "optim",
    "parallel",
    "sampler",
    "utils",
]
