"""Alias of the pynqs-compatible sampler API (reference python/pynqs/sampler.py:11-71).

``RBM``/``FFNN`` dispatch on floatType x symmType and expose
``init / do_mcmc_steps / get_spinStates / get_lnpsi /
get_lnpsi_for_fixed_spins`` exactly as the reference binding does; the
implementation lives in neural_network_quantum_state_tpu_torch.api.sampler.
"""

from neural_network_quantum_state_tpu_torch.api.sampler import FFNN, RBM

__all__ = ["RBM", "FFNN"]
