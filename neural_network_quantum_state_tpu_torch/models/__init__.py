"""Ansatz registry: the JAX package's names, case-insensitive."""

from neural_network_quantum_state_tpu_torch.models.base import Machine, Params, params_from_jax
from neural_network_quantum_state_tpu_torch.models.ffnn import FFNN, FFNNSfSymm, FFNNTrSymm
from neural_network_quantum_state_tpu_torch.models.rbm import RBM, RBMSfSymm, RBMTrSymm, RBMZ2PrSymm

REGISTRY = {
    "rbm": RBM,
    "rbmtrsymm": RBMTrSymm,
    "rbmsfsymm": RBMSfSymm,
    "rbmz2prsymm": RBMZ2PrSymm,
    "ffnn": FFNN,
    "ffnntrsymm": FFNNTrSymm,
    "ffnnsfsymm": FFNNSfSymm,
}


def get_machine(name: str, **kwargs) -> Machine:
    """Build a machine by registry name (case-insensitive)."""
    return REGISTRY[name.lower()](**kwargs)


__all__ = [
    "FFNN",
    "FFNNSfSymm",
    "FFNNTrSymm",
    "Machine",
    "Params",
    "RBM",
    "RBMSfSymm",
    "RBMTrSymm",
    "RBMZ2PrSymm",
    "REGISTRY",
    "get_machine",
    "params_from_jax",
]
