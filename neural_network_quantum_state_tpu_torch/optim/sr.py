"""Stochastic Reconfiguration (imaginary-time natural gradient).

With per-walker log-derivatives O (K,V) and local energies Etilde (K,):

    aO_i   = <O_i>
    S_ij   = <O_i* O_j> - aO_i* aO_j                 (Hermitian PSD)
    F_i    = <Etilde O_i*> - <Etilde> aO_i*
    theta <- theta - dt * S^{-1} F

Regularization schedule lambda(n) = max(100 * 0.9^(n+1), 1e-2); the
matrix-free solve adds lambda*diag(S) to the matvec and preconditions with
1/((1+lambda) diag(S)).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from neural_network_quantum_state_tpu_torch.optim.cg import CGResult, cg_solve

LAMBDA0, LAMBDA_DECAY, LAMBDA_MIN = 100.0, 0.9, 1e-2


def lambda_schedule(step: int) -> float:
    """lambda(n) = max(100 * 0.9^(n+1), 1e-2), once per iteration before the solve."""
    return max(LAMBDA0 * LAMBDA_DECAY ** (step + 1.0), LAMBDA_MIN)


class SRStats(NamedTuple):
    energy: torch.Tensor  # () complex: <Etilde>
    rsd: torch.Tensor  # () real: sqrt(var/|mean|^2)
    cg_iters: int
    lam: float


def _abs2(a: torch.Tensor) -> torch.Tensor:
    return a.real * a.real + a.imag * a.imag


def energy_and_rsd(htilda: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    havg = htilda.mean()
    h2 = _abs2(havg)
    var = _abs2(htilda).mean() - h2
    return havg, torch.sqrt(torch.clamp(var, min=0.0) / h2)


def force_vector(o_mat: torch.Tensor, htilda: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """F_i = <Etilde O_i*> - <Etilde><O_i>*; returns (F, aO)."""
    k = o_mat.shape[0]
    a_o = o_mat.mean(0)
    f = (htilda @ o_mat.conj()) / k - htilda.mean() * a_o.conj()
    return f, a_o


def sr_diag(o_mat: torch.Tensor, a_o: torch.Tensor) -> torch.Tensor:
    """diag(S)_i = <|O_i|^2> - |aO_i|^2 (real)."""
    return _abs2(o_mat).mean(0) - _abs2(a_o)


def sr_cg_solve(
    o_mat: torch.Tensor,
    htilda: torch.Tensor,
    lam: float,
    tol: float = 1e-5,
    max_iters: int = 1000,
) -> tuple[torch.Tensor, CGResult]:
    """Matrix-free SR solve: never materializes S (O(KV), not O(V^2))."""
    k = o_mat.shape[0]
    f, a_o = force_vector(o_mat, htilda)
    diag = sr_diag(o_mat, a_o)
    o_h = o_mat.conj().T
    a_o_c = a_o.conj()

    def matvec(a: torch.Tensor) -> torch.Tensor:
        b = (o_h @ (o_mat @ a)) * (1.0 / k)  # O^H O a / K
        b = b - a_o_c * (a_o @ a)
        return b + (lam * diag) * a

    # Relative floor on the preconditioner diagonal: zero-variance parameter
    # directions (frozen spins, symmetric cancellations) make diag(S)_i = 0
    # exactly, and 1/((1+lam)*diag) would blow the search directions up.
    floor = 1e-10 * diag.max() + torch.finfo(diag.dtype).tiny
    inv_pdiag = 1.0 / ((1.0 + lam) * torch.maximum(diag, floor))

    res = cg_solve(matvec, f, precond=lambda r: inv_pdiag * r, tol=tol, max_iters=max_iters)
    return res.x, res
