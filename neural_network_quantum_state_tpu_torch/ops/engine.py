"""Generic batched log-cosh machine engine.

Every RBM-family ansatz has the functional form

    ln psi(s) = sum_j logcosh( b_j + sum_i W_ij s_i ) + sum_i a_i s_i

over effective (possibly symmetry-expanded) complex weights W (N,H), hidden
bias b (H,) and visible bias a (N,). This module evaluates that form batched
over walkers (leading axis K) with the O(H)-per-proposal incremental update
of the hidden pre-activations

    y'_kj = y_kj - 2 s_ki W_ij          (candidate: flip spin i)

Spins are real {-1,+1}; y, sa and ln psi are native complex tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from neural_network_quantum_state_tpu_torch.ops.logcosh import logcosh


class Work(NamedTuple):
    """Effective dense weights of a log-cosh machine (symmetry-expanded)."""

    w: torch.Tensor  # (N, H) complex
    b: torch.Tensor  # (H,) complex
    a: Optional[torch.Tensor] = None  # (N,) complex or None (no visible bias)


class Cache(NamedTuple):
    """Per-walker machine state threaded through the sampler."""

    spins: torch.Tensor  # (K, N) real, entries in {-1, +1}
    y: torch.Tensor  # (K, H) complex pre-activations
    sa: torch.Tensor  # (K,) complex visible-bias term


def _real_matmul(s: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """real (K, N) @ complex (N, ...) as two real products."""
    return torch.complex(s @ m.real, s @ m.imag)


def full_forward(work: Work, spins: torch.Tensor) -> tuple[Cache, torch.Tensor]:
    """From-scratch forward: build the cache and ln psi for all walkers."""
    s = spins.to(work.w.real.dtype)
    y = _real_matmul(s, work.w) + work.b
    if work.a is not None:
        sa = _real_matmul(s, work.a)
    else:
        sa = torch.zeros(s.shape[0], dtype=work.w.dtype, device=s.device)
    lnpsi = logcosh(y).sum(-1) + sa
    return Cache(spins=s, y=y, sa=sa), lnpsi


def log_psi(work: Work, spins: torch.Tensor) -> torch.Tensor:
    """Pure fixed-spin ln psi (K,) complex."""
    return full_forward(work, spins)[1]


def flip_log_psi(work: Work, cache: Cache, site: int) -> torch.Tensor:
    """ln psi of the candidate state with `site` flipped in every walker."""
    two_s = 2.0 * cache.spins[:, site]  # (K,) real
    y1 = cache.y - two_s[:, None] * work.w[site]
    lnpsi = logcosh(y1).sum(-1) + cache.sa
    if work.a is not None:
        lnpsi = lnpsi + (-two_s) * work.a[site]
    return lnpsi


def commit_flip(work: Work, cache: Cache, site: int, accept: torch.Tensor) -> Cache:
    """Commit the single-site flip on walkers where `accept` is True.

    Branchless masked update: y and sa move by the pre-flip spin value, then
    the spin is negated. Returns a new Cache; the input is left unchanged.
    """
    acc = accept.to(cache.spins.dtype)
    two_s = (2.0 * cache.spins[:, site]) * acc  # 0 where rejected
    y = cache.y - two_s[:, None] * work.w[site]
    sa = cache.sa
    if work.a is not None:
        sa = sa - two_s * work.a[site]
    spins = cache.spins.clone()
    spins[:, site] *= 1.0 - 2.0 * acc
    return Cache(spins=spins, y=y, sa=sa)


def all_flip_log_psi(work: Work, cache: Cache, sites: torch.Tensor) -> torch.Tensor:
    """ln psi of every single-site flip in `sites` for every walker: (K, n).

    y1[k,i,j] = y[k,j] - 2 s[k,i] W[i,j], then log-cosh and the hidden sum.
    Memory O(K * n * H); callers chunk over `sites`.
    """
    two_s = 2.0 * cache.spins[:, sites]  # (K, n) real
    y1 = cache.y[:, None, :] - two_s[:, :, None] * work.w[sites][None]
    lnpsi = logcosh(y1).sum(-1) + cache.sa[:, None]
    if work.a is not None:
        lnpsi = lnpsi + (-two_s) * work.a[sites][None, :]
    return lnpsi
