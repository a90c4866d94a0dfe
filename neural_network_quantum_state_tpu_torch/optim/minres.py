"""MINRES and MINRES-QLP for Hermitian (possibly indefinite or singular)
systems, matrix-free over complex vectors.

``minres_solve`` is Lanczos + Givens MINRES (Paige & Saunders 1975).
``minres_qlp_solve`` is MINRES-QLP (Choi, Paige & Saunders, SIAM J. Sci.
Comput. 33(4), 2011) in always-QLP mode: right-side rotations turn the
MINRES triangular factor into a lower-tridiagonal one, which yields the
minimum-length least-squares solution on singular systems (x -> pinv(A) b),
the reference's MINRESQLP contract. Both are the JAX package's recurrences
line for line; where JAX runs a ``lax.while_loop`` these loops run on the
host, as the CG solve does (``optim/cg.py``): the Lanczos vectors stay on
the tensors' device, and each iteration reads its two new Lanczos scalars
(alpha, ||p||) in one transfer. As A is Hermitian the Lanczos tridiagonal
is real, so every rotation and recurrence is a pair of Python floats.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from neural_network_quantum_state_tpu_torch.optim.cg import _norm2, _vdot_re


class MinresResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    rel_residual: float


def _lanczos_step(matvec, v, v_prev, beta):
    """p = A v - alpha v - beta v_prev with alpha = Re <A v, v>; returns
    (p, alpha, ||p||), the two scalars read in one transfer."""
    p = matvec(v)
    alpha = _vdot_re(p, v)
    p = p - v * alpha - v_prev * beta
    alpha_f, norm_f = torch.stack([alpha, torch.sqrt(_norm2(p))]).tolist()
    return p, alpha_f, norm_f


def minres_solve(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    rhs: torch.Tensor,
    tol: float = 1e-9,
    max_iters: int = 1000,
) -> MinresResult:
    """Solve A x = rhs for Hermitian A; stops when |eta| <= tol ||rhs|| or
    after max_iters."""
    beta1 = math.sqrt(float(_norm2(rhs)))
    safe_beta1 = beta1 if beta1 != 0 else 1.0
    v = rhs * (1.0 / safe_beta1)
    v_old = torch.zeros_like(rhs)
    w = torch.zeros_like(rhs)
    w_old = torch.zeros_like(rhs)
    x = torch.zeros_like(rhs)
    beta, eta = 0.0, beta1
    gamma0, gamma1, sigma0, sigma1 = 1.0, 1.0, 0.0, 0.0
    it = 0
    while it < max_iters and abs(eta) > tol * beta1:
        p, alpha, beta_new = _lanczos_step(matvec, v, v_old, beta)
        v_new = p * (1.0 / (beta_new if beta_new != 0 else 1.0))
        # the previous Givens rotations applied to the new tridiagonal column
        delta = gamma1 * alpha - gamma0 * sigma1 * beta
        rho1 = math.sqrt(delta * delta + beta_new * beta_new)
        rho2 = sigma1 * alpha + gamma0 * gamma1 * beta
        rho3 = sigma0 * beta
        safe_rho1 = rho1 if rho1 != 0 else 1.0
        gamma_new = delta / safe_rho1
        sigma_new = beta_new / safe_rho1
        w_new = (v - w_old * rho3 - w * rho2) * (1.0 / safe_rho1)
        x = x + w_new * (gamma_new * eta)
        eta = -sigma_new * eta
        v_old, v, w_old, w = v, v_new, w, w_new
        beta, gamma0, gamma1, sigma0, sigma1 = beta_new, gamma1, gamma_new, sigma1, sigma_new
        it += 1
    if beta1 == 0:
        x = torch.zeros_like(x)
    return MinresResult(x=x, iterations=it, rel_residual=abs(eta) / safe_beta1)


def _sym_givens(a: float, b: float) -> tuple[float, float, float]:
    """Stable real Givens (SymOrtho): c a + s b = r; (0, 0) -> (1, 0, 0)."""
    r = math.hypot(a, b)
    if r == 0:
        return 1.0, 0.0, 0.0
    return a / r, b / r, r


def _div(a: float, b: float) -> float:
    """a / b with IEEE semantics for b = 0 (as the JAX recurrences divide)."""
    if b != 0:
        return a / b
    return math.nan if a == 0 or math.isnan(a) else math.copysign(math.inf, a)


def minres_qlp_solve(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    rhs: torch.Tensor,
    tol: float = 1e-9,
    max_iters: int = 1000,
    max_xnorm: float = 1e7,
) -> MinresResult:
    """Minimum-length solution of the Hermitian least-squares problem
    min ||x|| s.t. x minimizes ||A x - rhs||.

    Stops when the iterations run out, the residual converges
    (phi <= tol ||rhs||), Lanczos breaks down (||p|| <= eps ||rhs||), or
    ||A r|| / (||A|| ||r||) <= tol (the least-squares test of a singular
    inconsistent system)."""
    eps = torch.finfo(rhs.real.dtype).eps
    beta1 = math.sqrt(float(_norm2(rhs)))
    safe_beta1 = beta1 if beta1 != 0 else 1.0
    zv = torch.zeros_like(rhs)
    v_prev, v, xl2, wl, w, x = zv, rhs * (1.0 / safe_beta1), zv, zv, zv, zv
    betan = beta1
    cs, sn, dltan = -1.0, 0.0, 0.0
    gama = gamal = 0.0
    cr1, sr1, cr2, sr2 = -1.0, 0.0, -1.0, 0.0
    vepln = veplnl = veplnl2 = 0.0
    eta = etal = etal2 = 0.0
    phi, tau, taul = beta1, 0.0, 0.0
    u = ul = ul2 = ul3 = 0.0
    gmax = xl2norm = anorm = 0.0
    arnorm_rel = 1.0
    it = 0
    while it < max_iters and phi > tol * beta1 and betan > eps * safe_beta1 and arnorm_rel > tol:
        # Lanczos: beta_{k+1} v_{k+1} = A v_k - alfa v_k - beta_k v_{k-1}
        beta = betan
        p, alfa, betan = _lanczos_step(matvec, v, v_prev, beta)
        v_new = p * (1.0 / (betan if betan != 0 else 1.0))

        # the previous left rotation Q_{k-1} applied to the new column
        dbar = dltan
        dlta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        eplnn = sn * betan
        dltan = -cs * betan
        # the current left rotation Q_k
        gamal2, gamal = gamal, gama
        cs, sn, gama = _sym_givens(gbar, betan)
        taul2, taul = taul, tau
        tau = cs * phi
        phi = sn * phi

        # the previous right rotation P_{k-2,k}
        if it >= 2:
            veplnl2, etal2, etal = veplnl, etal, eta
            dlta_r = sr2 * vepln - cr2 * dlta
            veplnl = cr2 * vepln + sr2 * dlta
            eta = sr2 * gama
            gama_r = -cr2 * gama
        else:
            dlta_r, gama_r = dlta, gama
        # the current right rotation P_{k-1,k}
        gamal_rr, gama_rr = gamal, gama_r
        if it >= 1:
            cr1, sr1, gamal_rr = _sym_givens(gamal, dlta_r)
            vepln = sr1 * gama_r
            gama_rr = -cr1 * gama_r

        # the solution's coefficient recurrences (t = L^{-1} rhs)
        ul3_old, ul3 = ul3, ul2
        if it >= 2:
            ul2 = (taul2 - etal2 * ul3_old - veplnl2 * ul3) / (gamal2 if gamal2 != 0 else 1.0)
        if it >= 1:
            ul = (taul - etal * ul3 - veplnl * ul2) / (gamal_rr if gamal_rr != 0 else 1.0)
        gmax = max(gmax, abs(gamal_rr), abs(gama_rr))
        xnorm_tmp = math.sqrt(xl2norm**2 + ul2**2 + ul**2)
        singular = abs(gama_rr) <= gmax * (eps * 10.0) or xnorm_tmp >= max_xnorm
        u = 0.0 if singular else (tau - eta * ul2 - vepln * ul) / gama_rr
        # minresQLP's maxxnorm guard: a step past the norm ceiling is a
        # null-space direction amplified by roundoff; drop it
        if math.sqrt(xnorm_tmp**2 + u**2) > max_xnorm:
            u = 0.0
        xl2norm = math.sqrt(xl2norm**2 + ul2**2)

        # the right-reflected basis (always-QLP mode)
        if it == 0:
            wl2, wl, w = wl, v * sr1, v * (-cr1)  # P still at its start (cr1 = -1, sr1 = 0)
        elif it == 1:
            wl2, wl, w = wl, w * cr1 + v * sr1, w * sr1 - v * cr1
        else:
            w_n = wl * sr2 - v * cr2
            wl2 = wl * cr2 + v * sr2
            wl, w = w * cr1 + w_n * sr1, w * sr1 - w_n * cr1
        xl2 = xl2 + wl2 * ul2
        x = xl2 + wl * ul + w * u

        # the next right rotation P_{k-1,k+1} (finalizes gamal)
        cr2, sr2, gamal = _sym_givens(gamal_rr, eplnn)
        gama = gama_rr

        # ||A r_{k-1}|| = ||r_{k-1}|| hypot(gbar_k, dltan_{k+1}), for the least-squares stop
        anorm = max(anorm, math.sqrt(beta**2 + alfa**2 + betan**2))
        arnorm_rel = _div(math.hypot(gbar, dltan), anorm)
        v_prev, v = v, v_new
        it += 1
    if beta1 == 0:
        x = torch.zeros_like(x)
    return MinresResult(x=x, iterations=it, rel_residual=phi / safe_beta1)


def sr_minres_solve(o_mat: torch.Tensor, htilda: torch.Tensor, lam: float, tol: float = 1e-9, max_iters: int = 1000):
    """Matrix-free SR solve by MINRES-QLP (the reference's MINRESQLP
    backend): the minimum-length solution even where the sampled S is
    numerically rank-deficient. Returns (dx, MinresResult). O and Etilde
    sharded over a walker mesh are gathered onto the first shard's device
    first."""
    from neural_network_quantum_state_tpu_torch.optim.sr import _s_matvec, force_vector, sr_diag
    from neural_network_quantum_state_tpu_torch.parallel.mesh import gather

    o_mat, htilda = gather(o_mat), gather(htilda)
    f, a_o = force_vector(o_mat, htilda)
    res = minres_qlp_solve(_s_matvec(o_mat, a_o, sr_diag(o_mat, a_o), lam), f, tol=tol, max_iters=max_iters)
    return res.x, res
