"""Hamiltonian protocol.

A Hamiltonian is a frozen config exposing:

- ``schedule()``: site-visit order for the Metropolis sweep,
- ``init_spins(g, n_walkers, dtype)``: initial spin states on ``g.device``,
- ``local_energy(work, cache, lnpsi)``: per-walker local energy
  Etilde(s) = sum_s' <s|H|s'> psi(s')/psi(s)   -> (K,) complex.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from neural_network_quantum_state_tpu_torch.ops.engine import Cache, Work
from neural_network_quantum_state_tpu_torch.ops.rng import random_spins


@dataclasses.dataclass(frozen=True)
class Hamiltonian:
    n_sites: int

    def schedule(self) -> np.ndarray:
        raise NotImplementedError

    def init_spins(self, g: torch.Generator, n_walkers: int, dtype=torch.float32) -> torch.Tensor:
        """Default: all spins up."""
        return torch.ones((n_walkers, self.n_sites), dtype=dtype, device=g.device)

    def reseed_spins(self, g: torch.Generator, n_walkers: int, dtype=torch.float32) -> torch.Tensor:
        """Fresh walker configurations for collapse remediation: uniform
        random +-1 (not init_spins, whose ordered starts are exactly the
        configuration a collapsed ensemble is pinned on)."""
        return random_spins(g, n_walkers, self.n_sites, dtype)

    def local_energy(self, work: Work, cache: Cache, lnpsi: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError
