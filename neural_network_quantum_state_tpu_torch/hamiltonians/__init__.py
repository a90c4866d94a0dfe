from neural_network_quantum_state_tpu_torch.hamiltonians.base import Hamiltonian
from neural_network_quantum_state_tpu_torch.hamiltonians.hubbard import HubbardChain
from neural_network_quantum_state_tpu_torch.hamiltonians.ising import LITFIChain, TFIChain, TFICheckerBoard, TFISQ, TFITRI

REGISTRY = {
    "tfichain": TFIChain,
    "litfichain": LITFIChain,
    "tfisq": TFISQ,
    "tfitri": TFITRI,
    "tficheckerboard": TFICheckerBoard,
    "hubbardchain": HubbardChain,
}

__all__ = ["Hamiltonian", "HubbardChain", "LITFIChain", "REGISTRY", "TFIChain", "TFICheckerBoard", "TFISQ", "TFITRI"]
