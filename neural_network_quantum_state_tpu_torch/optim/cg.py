"""Preconditioned conjugate gradient over complex Hermitian operators.

Matrix-free ``matvec``/``precond`` callables over complex (V,) vectors;
exits when ||r||^2 < max(tol^2 * ||rhs||^2, tiny) or after max_iters. The
loop runs on the host and reads the residual norm after every iteration.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_norm2: float  # final ||r||^2


def _norm2(a: torch.Tensor) -> torch.Tensor:
    return (a.real * a.real + a.imag * a.imag).sum()


def _vdot_re(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Re <a, b> = Re sum(a * conj(b))."""
    return (a.real * b.real + a.imag * b.imag).sum()


def cg_solve(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    rhs: torch.Tensor,
    precond: Callable[[torch.Tensor], torch.Tensor] | None = None,
    tol: float = 1e-5,
    max_iters: int = 1000,
) -> CGResult:
    if precond is None:
        precond = lambda r: r
    x = torch.zeros_like(rhs)
    rhs_norm2 = float(_norm2(rhs))
    if rhs_norm2 == 0.0:
        return CGResult(x=x, iterations=0, residual_norm2=0.0)  # rhs == 0 -> x = 0 exactly
    threshold = max(tol * tol * rhs_norm2, torch.finfo(rhs.real.dtype).tiny)

    r = rhs - matvec(x)
    p = precond(r)
    abs_new = _vdot_re(p, r)
    res_norm2 = float(_norm2(r))
    it = 0
    while it < max_iters and res_norm2 >= threshold:
        ap = matvec(p)
        alpha = abs_new / _vdot_re(ap, p)
        x = x + p * alpha
        r = r - ap * alpha
        res_norm2 = float(_norm2(r))
        z = precond(r)
        abs_old = abs_new
        abs_new = _vdot_re(z, r)
        p = z + p * (abs_new / abs_old)
        it += 1
    return CGResult(x=x, iterations=it, residual_norm2=res_norm2)
