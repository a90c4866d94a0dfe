"""pynqs-compatible Python sampling API (reference L9)."""

from neural_network_quantum_state_tpu_torch.api import sampler
from neural_network_quantum_state_tpu_torch.api.sampler import FFNN, RBM

__all__ = ["FFNN", "RBM", "sampler"]
