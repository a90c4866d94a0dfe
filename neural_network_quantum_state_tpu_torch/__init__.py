"""PyTorch/CUDA port of neural_network_quantum_state_tpu.

Same module layout and names as the JAX package. Plain tensor code is
PyTorch; the TPU kernels on the ported path are CUDA kernels for Hopper
(``csrc/``), each with a plain PyTorch version that runs on the CPU. Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from neural_network_quantum_state_tpu_torch.vmc import VMC, VMCConfig

__all__ = ["VMC", "VMCConfig"]
