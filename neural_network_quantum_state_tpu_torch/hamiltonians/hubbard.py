"""1D Fermi-Hubbard chain via the Jordan-Wigner mapping onto 2L spins.

Machine inputs: [0, L) are the spin-up orbitals, [L, 2L) the spin-down
ones; spin +1 is occupied, -1 empty.

Local energy (ket-side occupancies s):
    hopping:  -0.25 t sum_{flavor, dir} (1 + s_a)(1 - s_b) psi(flip_ab s)/psi(s)
    PBC edge: -0.25 t * 2 JWstring (1 - s_a s_b) * ratio, with
              JWstring = prod over the flavor's interior sites of (-s_i)
    onsite:   0.25 U sum_i (1 + s_i^up)(1 + s_i^dn)
    trap:     0.5 sum_i V_i (1 + s_i)
    scaled by 1/L when scale_per_site.

The pair-flip ratios are plain PyTorch on every device, chunked over the
pairs under the same element cap as the off-diagonal sum of
``ops.energy``. Sampling is the Kawasaki pair exchange
(``sampler.kawasaki``), which conserves the particle numbers.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Optional, Tuple

import numpy as np
import torch

from neural_network_quantum_state_tpu_torch.hamiltonians.base import Hamiltonian
from neural_network_quantum_state_tpu_torch.ops import engine
from neural_network_quantum_state_tpu_torch.ops.energy import OFFDIAG_CHUNK_ELEMS
from neural_network_quantum_state_tpu_torch.ops.engine import Cache, Work
from neural_network_quantum_state_tpu_torch.ops.rng import sector_spins
from neural_network_quantum_state_tpu_torch.sampler import kawasaki


@dataclasses.dataclass(frozen=True)
class HubbardChain(Hamiltonian):
    """n_sites here is the machine input count 2L (JW spins)."""

    u: float = 4.0
    t: float = 1.0
    n_up: int = 0
    n_down: int = 0
    # Total particle count scattered over all 2L inputs; overrides
    # (n_up, n_down) when set. Pair with per_flavor_rings=False so that
    # exchange moves conserve only the total.
    n_particles: Optional[int] = None
    pbc: bool = True
    v: Optional[tuple] = None  # length-2L site potential, or None
    per_flavor_rings: bool = True  # one ring per flavor, or one over all 2L inputs
    scale_per_site: bool = True  # the 1/L energy scale

    def __post_init__(self):
        if self.n_sites % 2 != 0:
            raise ValueError("HubbardChain needs an even machine input count (2L)")
        if self.v is not None and len(self.v) != self.n_sites:
            raise ValueError("V must have length 2L")

    @property
    def l(self) -> int:
        return self.n_sites // 2

    # ---- sampler wiring --------------------------------------------------
    sampler_kind = "exchange"

    @cached_property
    def bonds(self) -> np.ndarray:
        """(B, 2) int32 exchange bonds; the VMC puts them on the walkers' device."""
        if self.per_flavor_rings:
            return kawasaki.two_ring_bonds(self.l)
        return kawasaki.ring_bonds(self.n_sites)

    @property
    def n_unit_steps(self) -> int:
        return self.n_sites  # proposals per sweep

    def schedule(self) -> np.ndarray:  # unused by the exchange sampler
        return np.arange(self.n_sites, dtype=np.int32)

    def init_spins(self, g: torch.Generator, n_walkers: int, dtype=torch.float32) -> torch.Tensor:
        """Random placement of n_up particles in [0, L) and n_down in
        [L, 2L) per walker, or of n_particles over all 2L inputs."""
        if self.n_particles is not None:
            return sector_spins(g, n_walkers, self.n_sites, self.n_particles, dtype)
        up = sector_spins(g, n_walkers, self.l, self.n_up, dtype)
        dn = sector_spins(g, n_walkers, self.l, self.n_down, dtype)
        return torch.cat([up, dn], dim=1)

    def reseed_spins(self, g: torch.Generator, n_walkers: int, dtype=torch.float32) -> torch.Tensor:
        """Collapse remediation must stay in the particle sector (the
        exchange proposals never leave it): fresh random sector states."""
        return self.init_spins(g, n_walkers, dtype)

    # ---- local energy ----------------------------------------------------
    @cached_property
    def _hop_pairs(self) -> Tuple[np.ndarray, np.ndarray]:
        """Interior hopping pairs (a_t, b_t), both directions, both flavors."""
        l = self.l
        a_list, b_list = [], []
        for s in (0, 1):
            off = s * l
            for i in range(l - 1):  # left to right: (i, i+1)
                a_list.append(off + i)
                b_list.append(off + i + 1)
            for i in range(1, l):  # right to left: (i, i-1)
                a_list.append(off + i)
                b_list.append(off + i - 1)
        return np.asarray(a_list, np.int64), np.asarray(b_list, np.int64)

    def _pairs(self) -> Tuple[np.ndarray, np.ndarray]:
        """Interior pairs, then the two PBC edge pairs (0, L-1), (L, 2L-1)."""
        a_idx, b_idx = self._hop_pairs
        if self.pbc:
            a_idx = np.concatenate([a_idx, [0, self.l]])
            b_idx = np.concatenate([b_idx, [self.l - 1, 2 * self.l - 1]])
        return a_idx, b_idx

    def local_energy(self, work: Work, cache: Cache, lnpsi: torch.Tensor) -> torch.Tensor:
        l = self.l
        s = cache.spins  # (K, 2L)
        dev = s.device
        all_a = self.device_table("pair_a", dev, torch.int64, lambda: self._pairs()[0])
        all_b = self.device_table("pair_b", dev, torch.int64, lambda: self._pairs()[1])
        k, h = s.shape[0], work.w.shape[1]
        chunk = max(1, OFFDIAG_CHUNK_ELEMS // max(1, k * h))
        ratio = torch.cat([
            torch.exp(engine.all_flip2_log_psi(work, cache, all_a[c : c + chunk], all_b[c : c + chunk]) - lnpsi[:, None])
            for c in range(0, all_a.shape[0], chunk)
        ], dim=1)  # (K, T)

        t_int = self._hop_pairs[0].shape[0]
        a_int, b_int = all_a[:t_int], all_b[:t_int]
        coeff_int = (1.0 + s[:, a_int]) * (1.0 - s[:, b_int])  # (K, T_int) real
        hop = (coeff_int * ratio[:, :t_int]).sum(1)

        if self.pbc:
            # edge term per flavor: 2 JWstring (1 - s_a s_b) ratio, with
            # JWstring = prod over the interior sites of (-s_i)
            sign = (-1.0) ** (l - 2)
            edge = []
            for f, (ea, eb) in enumerate(((0, l - 1), (l, 2 * l - 1))):
                interior = torch.prod(s[:, ea + 1 : eb], dim=1) * sign
                ce = 2.0 * interior * (1.0 - s[:, ea] * s[:, eb])
                edge.append(ce * ratio[:, t_int + f])
            hop = hop + (edge[0] + edge[1])

        htilda = hop * (-0.25 * self.t)
        htilda = htilda + 0.25 * self.u * ((1.0 + s[:, :l]) * (1.0 + s[:, l:])).sum(1)
        if self.v is not None:
            vv = self.device_table("v", dev, s.dtype, lambda: np.asarray(self.v))
            htilda = htilda + 0.5 * (vv[None, :] * (1.0 + s)).sum(1)
        if self.scale_per_site:
            htilda = htilda * (1.0 / l)
        return htilda
