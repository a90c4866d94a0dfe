"""Kawasaki (particle-number-conserving) pair-exchange Metropolis sampler.

Proposals exchange the two ends of a randomly chosen active (anti-aligned)
bond, so the particle number is conserved: the move class of the
Jordan-Wigner Hubbard chain. The bond is chosen by the running-sum inverse
CDF over the active-bond mask (``ops.exchange.select_active_bond``).

``exchange_sweeps`` runs through ``ops.exchange.exchange_steps``. For
walkers on the card one call is one launch of the exchange kernel for all
its sweeps, as the JAX package's fused exchange: the call draws one Philox
key from the state's generator and the kernel draws its uniforms on the chip
(``rng.ExchangeDraws``), and ln psi is recomputed once per call. For walkers
on the CPU each sweep is one call of the plain PyTorch version on its own
(n_unit_steps, K) blocks of selection and acceptance uniforms from the
state's generator, so memory does not grow with the number of sweeps: a run
on the card is reproducible from its seed, but does not take the CPU run's
numbers.

Lattice topologies:
- ring_bonds(n): one ring over all inputs; exchanges may cross the up/down
  boundary (conserves the total particle number only).
- two_ring_bonds(l): two independent rings for the spin-up [0, L) and
  spin-down [L, 2L) inputs (conserves each flavor's particle number).
"""

from __future__ import annotations

import numpy as np
import torch

from neural_network_quantum_state_tpu_torch.ops.engine import Work
from neural_network_quantum_state_tpu_torch.ops.exchange import exchange_steps
from neural_network_quantum_state_tpu_torch.ops.rng import ExchangeDraws, philox_key, uniform_block
from neural_network_quantum_state_tpu_torch.sampler.metropolis import MCState


def ring_bonds(n: int) -> np.ndarray:
    """(n, 2) int32 spin indices of ring bonds b: (b, (b+1) % n)."""
    b = np.arange(n)
    return np.stack([b, (b + 1) % n], axis=1).astype(np.int32)


def two_ring_bonds(l: int) -> np.ndarray:
    """(2L, 2) int32 bonds of two independent rings: up [0, L), down [L, 2L)."""
    up = ring_bonds(l)
    return np.concatenate([up, up + l], axis=0).astype(np.int32)


def exchange_sweeps(work: Work, state: MCState, bonds: torch.Tensor, n_sweeps: int, n_unit_steps: int) -> MCState:
    """Run ``n_sweeps`` sweeps of ``n_unit_steps`` exchange proposals each:
    one kernel launch for all of them on the card, one ``exchange_steps``
    call per sweep on the CPU. `bonds` is the (B, 2) int32 table on the
    walkers' device."""
    k = state.lnpsi.shape[0]
    cache, lnpsi, n_acc = state.cache, state.lnpsi, state.n_accepted
    if cache.spins.device.type != "cpu":
        if n_sweeps * n_unit_steps > 0:
            draws = ExchangeDraws(philox_key(state.generator), n_sweeps * n_unit_steps)
            cache, lnpsi, acc = exchange_steps(work, cache, lnpsi, bonds, draws)
            n_acc = n_acc + acc
    else:
        for _ in range(n_sweeps):
            u_sel = uniform_block(state.generator, (n_unit_steps, k), cache.spins.dtype)
            u_acc = uniform_block(state.generator, (n_unit_steps, k), cache.spins.dtype)
            cache, lnpsi, acc = exchange_steps(work, cache, lnpsi, bonds, u_sel, u_acc)
            n_acc = n_acc + acc
    return MCState(
        cache=cache,
        lnpsi=lnpsi,
        generator=state.generator,
        n_accepted=n_acc,
        n_proposed=state.n_proposed + float(n_sweeps * n_unit_steps * k),
    )
