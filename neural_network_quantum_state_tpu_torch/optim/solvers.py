"""Dense linear solvers for the SR system.

The JAX package solves the Hermitian complex system S x = f through its
real 2V x 2V embedding, because the TPU has no complex linear algebra. Here
the solves are native complex ones (``torch.linalg``), which give the same
solutions: the embedding is symmetric positive definite exactly when S is
Hermitian positive definite, and its singular values are those of S, each
twice, so the SVD's relative cutoff drops the same directions.

| JAX package (real embedding) | here                      |
|------------------------------|---------------------------|
| lu_solve (jsl.solve)         | torch.linalg.solve        |
| cholesky_solve (cho_factor)  | torch.linalg.cholesky_ex  |
| svd_lstsq (rcond 1e-10)      | torch.linalg.svd          |

None of them reads a result back to the host: a failed factorisation gives
NaN, as the JAX solves do, and the VMC's trust region then skips the update.
"""

from __future__ import annotations

import torch


def lu_solve(s: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """General LU solve of S x = f (the reference's cuLUF / BKF)."""
    return torch.linalg.solve_ex(s, f)[0]


def cholesky_solve(s: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Hermitian positive-definite solve (the reference's MAGMA posv). A
    matrix that is not positive definite gives NaN, as JAX's cho_factor."""
    low, info = torch.linalg.cholesky_ex(s)
    low = torch.where(info == 0, low, torch.full_like(low, float("nan")))
    return torch.cholesky_solve(f[:, None], low)[:, 0]


def svd_lstsq(s: torch.Tensor, f: torch.Tensor, rcond: float = 1e-10) -> torch.Tensor:
    """Pseudo-inverse least squares: singular values at or below
    rcond * max are dropped (the reference's zgelsd with rcond = 1e-10)."""
    u, sv, vh = torch.linalg.svd(s, full_matrices=False)
    inv = torch.where(sv > rcond * sv.max(), 1.0 / sv, torch.zeros_like(sv))
    return vh.mH @ (inv.to(s.dtype) * (u.mH @ f))


SOLVERS = {
    "lu": lu_solve,
    "cholesky": cholesky_solve,
    "svd": svd_lstsq,
}
