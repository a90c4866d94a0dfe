"""Hamiltonian protocol.

A Hamiltonian is a frozen config exposing:

- ``sampler_kind``: ``"flip"`` (single-site Metropolis over ``schedule()``)
  or ``"exchange"`` (Kawasaki pair exchange over ``bonds``),
- ``schedule()``: site-visit order for the Metropolis sweep,
- ``init_spins(g, n_walkers, dtype)``: initial spin states on ``g.device``,
- ``local_energy(work, cache, lnpsi)``: per-walker local energy
  Etilde(s) = sum_s' <s|H|s'> psi(s')/psi(s)   -> (K,) complex;
  ``local_energy_sharded`` runs it once per shard of a walker mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from neural_network_quantum_state_tpu_torch.ops.engine import Cache, Work
from neural_network_quantum_state_tpu_torch.ops.rng import random_spins
from neural_network_quantum_state_tpu_torch.parallel.mesh import shard_map


@dataclasses.dataclass(frozen=True)
class Hamiltonian:
    n_sites: int

    sampler_kind = "flip"

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

    def local_energy_sharded(self, work: Work, cache: Cache, lnpsi):
        """The local energy of walkers sharded over a mesh (``Sharded`` cache
        and ln psi): ``local_energy`` once per shard on its device, with the
        work copied there, and a ``Sharded`` result. The local energy has no
        cross-walker terms, so nothing is reduced; on the card each shard of
        a spin chain or lattice is one energy-kernel launch, the Hubbard
        chain's plain local energy runs per shard."""
        return shard_map(self.local_energy, work, cache, lnpsi)

    def device_table(self, name: str, device: torch.device, dtype: torch.dtype, make: Callable[[], np.ndarray]) -> torch.Tensor:
        """A static table of the local energy (pair indices, couplings, a
        trap) as a tensor on `device`: built from make() at the first call
        for (name, device, dtype) and kept, so that a step copies nothing
        from the host."""
        tables = self.__dict__.setdefault("_device_tables", {})  # frozen: bypass __setattr__
        key = (name, torch.device(device), dtype)
        if key not in tables:
            tables[key] = torch.as_tensor(make(), dtype=dtype, device=device)
        return tables[key]
