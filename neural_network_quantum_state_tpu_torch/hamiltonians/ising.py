"""Transverse-field Ising Hamiltonians: chain, long-range chain, square,
triangular and checkerboard (J1-J2) lattices.

All share the local energy

    Etilde(s) = diag(s) + h * sum_i exp(lnpsi(flip_i s) - lnpsi(s))

with diag(s) = 0.5 * sum_i s_i * sum_n J[i,n] * s_{nn[i,n]} over J-weighted
neighbour tables (``_NeighborTFI``), or for LITFIChain a dense J-matrix
product and a 1/L per-site energy scale (the paper's model, J_ij =
J/d(i,j)^alpha). The N-flip off-diagonal term goes to
``ops.energy.offdiag_sum``: the CUDA kernel for walkers on the card (its
float32 or float64 instance), the chunked plain version on the CPU. With
``compensated=True`` (``energy_dtype="compensated"``) it is the
difference-first sum of ``engine.all_flip_delta_log_psi`` in float64,
PyTorch code on either device, as the JAX package computes it in XLA.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np
import torch

from neural_network_quantum_state_tpu_torch.hamiltonians.base import Hamiltonian
from neural_network_quantum_state_tpu_torch.ops import energy, engine
from neural_network_quantum_state_tpu_torch.ops.engine import Cache, Work
from neural_network_quantum_state_tpu_torch.ops.rng import random_spins
from neural_network_quantum_state_tpu_torch.sampler import schedule as sched


def _offdiag_sum_compensated(work: Work, cache: Cache, n_sites: int) -> torch.Tensor:
    """The compensated sum_i exp(lnpsi(flip_i s) - lnpsi(s)), complex128:
    float32 log-cosh differences summed in float64, exp and sum in float64,
    over site chunks of at most ``energy.OFFDIAG_CHUNK_ELEMS`` flip elements."""
    k, h = cache.spins.shape[0], work.w.shape[1]
    chunk = max(1, min(n_sites, energy.OFFDIAG_CHUNK_ELEMS // max(1, k * h)))
    total = torch.zeros(k, dtype=torch.complex128, device=cache.spins.device)
    for start in range(0, n_sites, chunk):
        sites = torch.arange(start, min(n_sites, start + chunk), device=cache.spins.device)
        d = engine.all_flip_delta_log_psi(work, cache, sites, accum_dtype=torch.float64)
        total = total + torch.exp(d).sum(-1)
    return total


class _NeighborTFI(Hamiltonian):
    """Shared neighbour-table TFI; subclasses define
    ``_tables() -> (nnidx (N, nnn) int, jmat (N, nnn) float)``."""

    @cached_property
    def _nn(self) -> tuple[np.ndarray, np.ndarray]:
        nnidx, jmat = self._tables()
        return np.asarray(nnidx, np.int64), np.asarray(jmat, np.float64)

    def diag_energy(self, spins: torch.Tensor) -> torch.Tensor:
        """0.5 * sum_i s_i * sum_n J[i,n] * s_nn  -> (K,) real."""
        nnidx = self.device_table("nnidx", spins.device, torch.int64, lambda: self._nn[0])
        jmat = self.device_table("jmat", spins.device, spins.dtype, lambda: self._nn[1])
        neigh = spins[:, nnidx]  # (K, N, nnn)
        return 0.5 * torch.einsum("kn,knm->k", spins, neigh * jmat[None])

    def local_energy(self, work: Work, cache: Cache, lnpsi: torch.Tensor, compensated: bool = False) -> torch.Tensor:
        if compensated:
            offdiag = _offdiag_sum_compensated(work, cache, self.n_sites)
            diag = self.diag_energy(cache.spins.to(torch.float64))
        else:
            offdiag = energy.offdiag_sum(work, cache, lnpsi)
            diag = self.diag_energy(cache.spins)
        return torch.complex(diag + self.h * offdiag.real, self.h * offdiag.imag)


@dataclasses.dataclass(frozen=True)
class TFIChain(_NeighborTFI):
    """1D PBC chain: H = J sum s_i s_{i+1} - h-term.

    The reference's sign convention: h enters the off-diagonal accumulation
    directly, so a standard transverse-field Ising model uses h < 0.
    """

    h: float = -1.0
    j: float = -1.0

    def _tables(self):
        n = self.n_sites
        i = np.arange(n)
        return np.stack([(i - 1) % n, (i + 1) % n], axis=1), np.full((n, 2), self.j)

    def schedule(self) -> np.ndarray:
        return sched.chain_checkerboard(self.n_sites)


@dataclasses.dataclass(frozen=True)
class LITFIChain(Hamiltonian):
    """Long-range Ising chain J_ij = J / d(i,j)^alpha; PBC circular distance
    d = min(|i-j|, L-|i-j|) or OBC d = |i-j|.

    Per-site energy: Etilde scaled by 1/L. Neel initial state when J > 0.
    """

    h: float = -1.0
    j: float = 1.0
    alpha: float = 2.0
    pbc: bool = True

    def __post_init__(self):
        if self.pbc and self.n_sites % 2 == 1:
            raise ValueError("PBC long-range chain requires even L (set pbc=False).")

    @cached_property
    def j_matrix(self) -> np.ndarray:
        """Full coupling matrix J_ij (numpy float64)."""
        l = self.n_sites
        i, j = np.meshgrid(np.arange(l), np.arange(l), indexing="ij")
        d = np.abs(i - j).astype(np.float64)
        if self.pbc:
            d = np.minimum(d, l - d)
        with np.errstate(divide="ignore"):
            jm = self.j * d**-self.alpha
        np.fill_diagonal(jm, 0.0)
        return jm

    def init_spins(self, g: torch.Generator, n_walkers: int, dtype=torch.float32) -> torch.Tensor:
        if self.j > 0:  # Neel start
            pattern = 1.0 - 2.0 * (torch.arange(self.n_sites, device=g.device) % 2).to(dtype)
            return pattern.expand(n_walkers, self.n_sites).contiguous()
        return torch.ones((n_walkers, self.n_sites), dtype=dtype, device=g.device)

    def schedule(self) -> np.ndarray:
        return sched.chain_checkerboard(self.n_sites)

    def local_energy(self, work: Work, cache: Cache, lnpsi: torch.Tensor, compensated: bool = False) -> torch.Tensor:
        s = cache.spins
        if compensated:
            s = s.to(torch.float64)
            offdiag = _offdiag_sum_compensated(work, cache, self.n_sites)
        else:
            offdiag = energy.offdiag_sum(work, cache, lnpsi)
        sj = s @ self.device_table("j_matrix", s.device, s.dtype, lambda: self.j_matrix)  # (K, L)
        diag = 0.5 * (sj * s).sum(-1)
        inv_l = 1.0 / self.n_sites
        return torch.complex((diag + self.h * offdiag.real) * inv_l, self.h * offdiag.imag * inv_l)


class _SquareLattice(_NeighborTFI):
    """n_sites = L * L, site = i * L + j."""

    @property
    def l(self) -> int:
        l = int(round(self.n_sites**0.5))
        if l * l != self.n_sites:
            raise ValueError(f"{type(self).__name__} requires n_sites = L*L")
        return l

    def _grid(self):
        l = self.l
        i, j = np.meshgrid(np.arange(l), np.arange(l), indexing="ij")
        return l, i, j, lambda a, b: ((a % l) * l + (b % l)).ravel()


@dataclasses.dataclass(frozen=True)
class TFISQ(_SquareLattice):
    """2D square L x L, PBC, 4 neighbours."""

    h: float = -1.0
    j: float = -1.0

    def _tables(self):
        l, i, j, site = self._grid()
        nnidx = np.stack([site(i, j - 1), site(i, j + 1), site(i - 1, j), site(i + 1, j)], axis=1)
        return nnidx, np.full((l * l, 4), self.j)

    def schedule(self) -> np.ndarray:
        return sched.square_checkerboard(self.l)


@dataclasses.dataclass(frozen=True)
class TFITRI(_SquareLattice):
    """2D (sheared) triangular L x L, PBC, 6 neighbours."""

    h: float = -1.0
    j: float = 1.0

    def _tables(self):
        l, i, j, site = self._grid()
        nnidx = np.stack(
            [site(i - 1, j - 1), site(i - 1, j), site(i, j - 1), site(i, j + 1), site(i + 1, j), site(i + 1, j + 1)],
            axis=1,
        )
        return nnidx, np.full((l * l, 6), self.j)

    def schedule(self) -> np.ndarray:
        return sched.triangular_threecolor(self.l)


@dataclasses.dataclass(frozen=True)
class TFICheckerBoard(_SquareLattice):
    """2D checkerboard (J1-J2) lattice, 8 neighbours with a per-bond J table,
    optional PBC. J2 bonds alternate diagonals by sublattice parity:
    (i+j) even: up-right and down-left; (i+j) odd: up-left and down-right.
    Random initial spins."""

    h: float = -1.0
    j1: float = -1.0
    j2: float = 0.0
    pbc: bool = True

    def _tables(self):
        l, i, j, site = self._grid()
        per = 1.0 if self.pbc else 0.0
        # order: up, down, left, right, up-right, down-left, up-left, down-right
        nnidx = np.stack(
            [site(i - 1, j), site(i + 1, j), site(i, j - 1), site(i, j + 1),
             site(i - 1, j + 1), site(i + 1, j - 1), site(i - 1, j - 1), site(i + 1, j + 1)],
            axis=1,
        )
        ii, jj = i.ravel(), j.ravel()
        jmat = np.zeros((l * l, 8))
        jmat[:, 0] = np.where(ii == 0, self.j1 * per, self.j1)
        jmat[:, 1] = np.where(ii == l - 1, self.j1 * per, self.j1)
        jmat[:, 2] = np.where(jj == 0, self.j1 * per, self.j1)
        jmat[:, 3] = np.where(jj == l - 1, self.j1 * per, self.j1)
        even = (ii + jj) % 2 == 0
        jmat[:, 4] = np.where(even, np.where((ii == 0) | (jj == l - 1), self.j2 * per, self.j2), 0.0)
        jmat[:, 5] = np.where(even, np.where((ii == l - 1) | (jj == 0), self.j2 * per, self.j2), 0.0)
        jmat[:, 6] = np.where(~even, np.where((ii == 0) | (jj == 0), self.j2 * per, self.j2), 0.0)
        jmat[:, 7] = np.where(~even, np.where((ii == l - 1) | (jj == l - 1), self.j2 * per, self.j2), 0.0)
        return nnidx, jmat

    def init_spins(self, g: torch.Generator, n_walkers: int, dtype=torch.float32) -> torch.Tensor:
        return random_spins(g, n_walkers, self.n_sites, dtype)

    def schedule(self) -> np.ndarray:
        return sched.square_checkerboard(self.l)
