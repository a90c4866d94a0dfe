from neural_network_quantum_state_tpu_torch.optim.cg import CGResult, cg_solve
from neural_network_quantum_state_tpu_torch.optim.sr import (
    SRStats,
    energy_and_rsd,
    force_vector,
    lambda_schedule,
    sr_cg_solve,
    sr_diag,
)

__all__ = [
    "CGResult", "SRStats", "cg_solve", "energy_and_rsd", "force_vector",
    "lambda_schedule", "sr_cg_solve", "sr_diag",
]
