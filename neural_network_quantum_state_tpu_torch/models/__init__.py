from neural_network_quantum_state_tpu_torch.models.base import Machine, Params, params_from_jax
from neural_network_quantum_state_tpu_torch.models.rbm import RBM, RBMTrSymm

__all__ = ["Machine", "Params", "RBM", "RBMTrSymm", "params_from_jax"]
