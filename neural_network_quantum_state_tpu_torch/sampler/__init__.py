from neural_network_quantum_state_tpu_torch.sampler.metropolis import (
    MCState,
    acceptance_ratio,
    block_flip_moves,
    init_state,
    sweeps,
)
from neural_network_quantum_state_tpu_torch.sampler.schedule import (
    chain_checkerboard,
    sequential,
    square_checkerboard,
    triangular_threecolor,
)

__all__ = [
    "MCState", "acceptance_ratio", "block_flip_moves", "chain_checkerboard", "init_state", "sequential",
    "square_checkerboard", "sweeps", "triangular_threecolor",
]
