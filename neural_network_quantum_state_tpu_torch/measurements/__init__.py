"""Measurement estimators (reference L7, cpu/include/measurements.hpp,
gpu/include/meas.cuh; the JAX package's ``measurements``)."""

from neural_network_quantum_state_tpu_torch.measurements import estimators, fermion
from neural_network_quantum_state_tpu_torch.measurements.estimators import (
    correlation_ratio,
    fidelity,
    measure_energy,
    neel_order,
    order_parameter,
    overlap_integral,
    renyi2_entropy,
    spin_x_correlation,
    spin_z_correlation,
    spontaneous_magnetization,
    structure_factor_trials,
)
from neural_network_quantum_state_tpu_torch.measurements.fermion import FermionAmplitudeSampler, opdm_pair
from neural_network_quantum_state_tpu_torch.measurements.renyi_increment import renyi2_increment
from neural_network_quantum_state_tpu_torch.measurements.sampler import AmplitudeSampler

__all__ = [
    "AmplitudeSampler",
    "FermionAmplitudeSampler",
    "estimators",
    "fermion",
    "correlation_ratio",
    "fidelity",
    "opdm_pair",
    "measure_energy",
    "neel_order",
    "order_parameter",
    "overlap_integral",
    "renyi2_entropy",
    "renyi2_increment",
    "spin_x_correlation",
    "structure_factor_trials",
    "spin_z_correlation",
    "spontaneous_magnetization",
]
