from neural_network_quantum_state_tpu_torch.optim import cg, minres, solvers, sr
from neural_network_quantum_state_tpu_torch.optim.cg import CGResult, cg_solve
from neural_network_quantum_state_tpu_torch.optim.minres import (
    MinresResult,
    minres_qlp_solve,
    minres_solve,
    sr_minres_solve,
)
from neural_network_quantum_state_tpu_torch.optim.sr import (
    SRStats,
    energy_and_rsd,
    force_vector,
    lambda_schedule,
    sgd_diag_solve,
    sr_cg_solve,
    sr_dense_solve,
    sr_diag,
)

__all__ = [
    "CGResult", "MinresResult", "SRStats", "cg", "cg_solve", "energy_and_rsd", "force_vector", "lambda_schedule",
    "minres", "minres_qlp_solve", "minres_solve", "sgd_diag_solve", "solvers", "sr", "sr_cg_solve", "sr_dense_solve",
    "sr_diag", "sr_minres_solve",
]
