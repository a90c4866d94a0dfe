from neural_network_quantum_state_tpu_torch.hamiltonians.base import Hamiltonian
from neural_network_quantum_state_tpu_torch.hamiltonians.hubbard import HubbardChain
from neural_network_quantum_state_tpu_torch.hamiltonians.ising import LITFIChain, TFIChain

__all__ = ["Hamiltonian", "HubbardChain", "LITFIChain", "TFIChain"]
