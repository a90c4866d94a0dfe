"""Utility subsystems: checkpointing, metrics, CLI config, exact reference
energies (the JAX package's ``utils``)."""

from neural_network_quantum_state_tpu_torch.utils import checkpoint, cli, exact, metrics
from neural_network_quantum_state_tpu_torch.utils.checkpoint import (
    load_npz,
    load_orbax,
    load_reference_text,
    save_npz,
    save_orbax,
    save_reference_text,
)
from neural_network_quantum_state_tpu_torch.utils.cli import DriverArgs
from neural_network_quantum_state_tpu_torch.utils.metrics import MetricsLogger

__all__ = [
    "DriverArgs",
    "MetricsLogger",
    "checkpoint",
    "cli",
    "exact",
    "load_npz",
    "load_orbax",
    "load_reference_text",
    "metrics",
    "save_npz",
    "save_orbax",
    "save_reference_text",
]
