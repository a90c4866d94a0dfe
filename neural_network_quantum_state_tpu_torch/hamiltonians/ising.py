"""Transverse-field Ising chains: nearest-neighbour and long-range.

Both share the local energy

    Etilde(s) = diag(s) + h * sum_i exp(lnpsi(flip_i s) - lnpsi(s))

The N-flip off-diagonal term goes to ``ops.energy.offdiag_sum``: the CUDA
kernel for walkers on the card, the chunked plain version on the CPU.

LITFIChain is the paper's model (long-range antiferromagnetic Ising chain,
J_ij = J/d(i,j)^alpha): a dense J-matrix product for the diagonal term and
a 1/L per-site energy scale.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np
import torch

from neural_network_quantum_state_tpu_torch.hamiltonians.base import Hamiltonian
from neural_network_quantum_state_tpu_torch.ops import energy
from neural_network_quantum_state_tpu_torch.ops.engine import Cache, Work
from neural_network_quantum_state_tpu_torch.sampler.schedule import chain_checkerboard


@dataclasses.dataclass(frozen=True)
class TFIChain(Hamiltonian):
    """1D PBC chain: H = J sum s_i s_{i+1} - h-term.

    The reference's sign convention: h enters the off-diagonal accumulation
    directly, so a standard transverse-field Ising model uses h < 0.
    """

    h: float = -1.0
    j: float = -1.0

    def schedule(self) -> np.ndarray:
        return chain_checkerboard(self.n_sites)

    def diag_energy(self, spins: torch.Tensor) -> torch.Tensor:
        """0.5 * sum_i s_i * J * (s_{i-1} + s_{i+1})  -> (K,) real."""
        neigh = torch.roll(spins, 1, dims=-1) + torch.roll(spins, -1, dims=-1)
        return 0.5 * self.j * (spins * neigh).sum(-1)

    def local_energy(self, work: Work, cache: Cache, lnpsi: torch.Tensor) -> torch.Tensor:
        offdiag = energy.offdiag_sum(work, cache, lnpsi)
        diag = self.diag_energy(cache.spins)
        return torch.complex(diag + self.h * offdiag.real, self.h * offdiag.imag)


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
        return chain_checkerboard(self.n_sites)

    def local_energy(self, work: Work, cache: Cache, lnpsi: torch.Tensor) -> torch.Tensor:
        s = cache.spins
        offdiag = energy.offdiag_sum(work, cache, lnpsi)
        sj = s @ torch.as_tensor(self.j_matrix, dtype=s.dtype, device=s.device)  # (K, L)
        diag = 0.5 * (sj * s).sum(-1)
        inv_l = 1.0 / self.n_sites
        return torch.complex((diag + self.h * offdiag.real) * inv_l, self.h * offdiag.imag * inv_l)
