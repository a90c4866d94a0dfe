from neural_network_quantum_state_tpu_torch.sampler.metropolis import MCState, init_state, sweeps
from neural_network_quantum_state_tpu_torch.sampler.schedule import chain_checkerboard

__all__ = ["MCState", "chain_checkerboard", "init_state", "sweeps"]
