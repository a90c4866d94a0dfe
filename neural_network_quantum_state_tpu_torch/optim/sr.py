"""Stochastic Reconfiguration (imaginary-time natural gradient).

With per-walker log-derivatives O (K,V) and local energies Etilde (K,):

    aO_i   = <O_i>
    S_ij   = <O_i* O_j> - aO_i* aO_j                 (Hermitian PSD)
    F_i    = <Etilde O_i*> - <Etilde> aO_i*
    theta <- theta - dt * S^{-1} F

Regularization schedule lambda(n) = max(100 * 0.9^(n+1), 1e-2); the
matrix-free solve adds lambda*diag(S) to the matvec and preconditions with
1/((1+lambda) diag(S)); the dense solves scale the diagonal, S_ii *=
(1+lambda); minSR solves the same system in walker space with an isotropic
ridge.

O and Etilde may be sharded over a walker mesh (``parallel/mesh.py``: one
row block per shard, on its device). Every walker sum (<Etilde>, aO, diag S,
F, the CG matvec's O^H (O a), the dense S = O^H O) is then taken per shard
and the O(V) partial sums are added on the first shard's device, on every
mesh layout (a TP mesh's walkers shard over all its devices). minSR gathers
O onto the first device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from neural_network_quantum_state_tpu_torch.optim.cg import CGResult, cg_solve
from neural_network_quantum_state_tpu_torch.parallel.mesh import Sharded, gather, reduce_sum, shard_map

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


def walker_mean(x, f=lambda v: v) -> torch.Tensor:
    """<f(x)> over the walkers (axis 0): the mean of a tensor, or of a
    ``Sharded`` one the shards' sums added on the first device over K."""
    if isinstance(x, Sharded):
        return reduce_sum(shard_map(lambda p: f(p).sum(0), x)) / x.shape[0]
    return f(x).mean(0)


def _hdot(v, o_mat) -> torch.Tensor:
    """O^H v = conj(conj(v) @ O) over the walkers (the shards' products
    added): conjugate vectors, never the (K, V) O."""
    return reduce_sum(shard_map(lambda vs, os: torch.conj_physical(torch.conj_physical(vs) @ os), v, o_mat))


def _gram(o_mat) -> torch.Tensor:
    """O^H O (V, V), the shards' products added."""
    return reduce_sum(shard_map(lambda os: os.mH @ os, o_mat))


def energy_and_rsd(htilda: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    havg = walker_mean(htilda)
    h2 = _abs2(havg)
    var = walker_mean(htilda, _abs2) - h2
    return havg, torch.sqrt(torch.clamp(var, min=0.0) / h2)


def force_vector(o_mat: torch.Tensor, htilda: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """F_i = <Etilde O_i*> - <Etilde><O_i>*; returns (F, aO)."""
    k = o_mat.shape[0]
    a_o = walker_mean(o_mat)
    f = _hdot(htilda, o_mat) / k - walker_mean(htilda) * a_o.conj()
    return f, a_o


def sr_diag(o_mat: torch.Tensor, a_o: torch.Tensor) -> torch.Tensor:
    """diag(S)_i = <|O_i|^2> - |aO_i|^2 (real)."""
    return walker_mean(o_mat, _abs2) - _abs2(a_o)


def _s_matvec(o_mat: torch.Tensor, a_o: torch.Tensor, diag: torch.Tensor, lam: float):
    """a -> (S + lam diag(S)) a, matrix-free: O^H (O a) / K - aO* (aO . a)
    plus the scaled diagonal. O^H (O a) is taken per shard of a sharded O
    (the (V,) products added)."""
    k = o_mat.shape[0]
    a_o_c = a_o.conj()

    def matvec(a: torch.Tensor) -> torch.Tensor:
        b = _hdot(shard_map(torch.matmul, o_mat, a), o_mat) * (1.0 / k)  # O^H O a / K
        b = b - a_o_c * (a_o @ a)
        return b + (lam * diag) * a

    return matvec


def sr_cg_solve(
    o_mat: torch.Tensor,
    htilda: torch.Tensor,
    lam: float,
    tol: float = 1e-5,
    max_iters: int = 1000,
    precond_diag: torch.Tensor | None = None,
) -> tuple[torch.Tensor, CGResult]:
    """Matrix-free SR solve: never materializes S (O(KV), not O(V^2)), nor
    conj(O): O^H u is formed as conj(conj(u) @ O), which conjugates two
    vectors (physically, so that no conjugate bit reaches the product)
    instead of the (K, V) matrix on every matvec.

    precond_diag: a replacement diagonal for the preconditioner only (a
    moving average of diag(S) over steps, ``VMCConfig.precond_ema``); the
    regularization always uses the current diag(S)."""
    f, a_o = force_vector(o_mat, htilda)
    diag = sr_diag(o_mat, a_o)
    matvec = _s_matvec(o_mat, a_o, diag, lam)
    # Relative floor on the preconditioner diagonal: zero-variance parameter
    # directions (frozen spins, symmetric cancellations) make diag(S)_i = 0
    # exactly, and 1/((1+lam)*diag) would blow the search directions up.
    pdiag = diag if precond_diag is None else precond_diag.to(diag.dtype)
    floor = 1e-10 * pdiag.max() + torch.finfo(diag.dtype).tiny
    inv_pdiag = 1.0 / ((1.0 + lam) * torch.maximum(pdiag, floor))

    res = cg_solve(matvec, f, precond=lambda r: inv_pdiag * r, tol=tol, max_iters=max_iters)
    return res.x, res


def build_s_matrix(o_mat: torch.Tensor, a_o: torch.Tensor) -> torch.Tensor:
    """Dense S = O^H O / K - conj(aO) aO^T, (V, V) Hermitian."""
    k = o_mat.shape[0]
    return _gram(o_mat) * (1.0 / k) - a_o.conj()[:, None] * a_o[None, :]


def _regularize_dense(s: torch.Tensor, lam: float) -> torch.Tensor:
    """S_ii *= (1 + lambda), plus a tiny absolute ridge 1e-7 max diag(S) +
    tiny: exact-zero diagonal rows (zero-variance parameter directions, a
    frozen visible bias) would leave the scaled matrix exactly singular."""
    diag = torch.diagonal(s).real
    ridge = 1e-7 * diag.max() + torch.finfo(diag.dtype).tiny
    return s + torch.diag_embed((lam * diag + ridge).to(s.dtype))


def sr_dense_solve(
    o_mat: torch.Tensor, htilda: torch.Tensor, lam: float, solver: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
) -> torch.Tensor:
    """Dense SR: build S (V, V), scale its diagonal by (1 + lambda), solve
    with one of ``optim.solvers.SOLVERS``."""
    f, a_o = force_vector(o_mat, htilda)
    return solver(_regularize_dense(build_s_matrix(o_mat, a_o), lam), f)


def sr_dense_solve_accumulated(
    samples: list[tuple[torch.Tensor, torch.Tensor]],
    lam: float,
    solver: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
) -> torch.Tensor:
    """Dense SR over several sampling rounds ``[(O, Etilde), ...]`` (the
    reference's naccumulation loop): S, F, aO and <E> are averaged over the
    rounds before the rank-1 terms are taken and the system is solved."""
    n_acc = len(samples)
    k = samples[0][0].shape[0]
    scale = 1.0 / (k * n_acc)
    s_sum = f_sum = a_sum = h_sum = 0.0
    for o_mat, htilda in samples:
        s_sum = s_sum + _gram(o_mat) * scale
        a_sum = a_sum + walker_mean(o_mat) * (1.0 / n_acc)
        h_sum = h_sum + walker_mean(htilda) * (1.0 / n_acc)
        f_sum = f_sum + _hdot(htilda, o_mat) * scale
    s = s_sum - a_sum.conj()[:, None] * a_sum[None, :]
    f = f_sum - h_sum * a_sum.conj()
    return solver(_regularize_dense(s, lam), f)


def sr_minsr_solve(
    o_mat: torch.Tensor,
    htilda: torch.Tensor,
    lam: float,
    solver: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """minSR (kernel-trick SR): the SR system solved in walker space.

    With centered Oc = O - <O> and eps = Etilde - <Etilde>, S = Oc^H Oc / K
    and F = Oc^H eps / K, so the ridge-regularized update is exactly

        dx = Oc^H (Oc Oc^H / K + l I_K)^{-1} eps / K,

    one K x K solve instead of a V x V one (Chen & Heyl, arXiv:2302.01941).
    The ridge is isotropic, l = lam * mean(diag S) + 1e-7 max(diag S) + tiny.
    Returns (dx, l); the solve is ``lu_solve`` unless another is given.
    """
    if solver is None:
        from neural_network_quantum_state_tpu_torch.optim.solvers import lu_solve

        solver = lu_solve
    o_mat, htilda = gather(o_mat), gather(htilda)
    k = o_mat.shape[0]
    oc = o_mat - o_mat.mean(0)
    eps = htilda - htilda.mean()
    diag_s = _abs2(oc).mean(0)  # == sr_diag(o_mat, aO)
    lam_abs = lam * diag_s.mean() + 1e-7 * diag_s.max() + torch.finfo(diag_s.dtype).tiny
    t = (oc @ oc.mH) * (1.0 / k)
    t = t + torch.diag_embed(lam_abs.to(t.dtype).expand(k))
    y = solver(t, eps * (1.0 / k))
    return oc.mH @ y, lam_abs


def sgd_diag_solve(o_mat: torch.Tensor, htilda: torch.Tensor, lam: float) -> torch.Tensor:
    """Diagonal-S-only update (the reference's StochasticGradientDescent):
    dx_i = F_i / ((1 + lambda) S_ii)."""
    f, a_o = force_vector(o_mat, htilda)
    return f / ((1.0 + lam) * sr_diag(o_mat, a_o))
