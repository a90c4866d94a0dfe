"""Vectorized single-spin-flip Metropolis sampler.

K walkers advance in lock-step through the site schedule. One sweep is
len(schedule) proposal rounds, each:

    lnpsi1 = flip ln psi          (O(K*H) incremental update)
    accept = u < min(1, exp(2 Re(lnpsi1 - lnpsi0)))
    masked commit of y, sa and the spin

``sweeps`` runs each sweep through ``ops.sweep.metropolis_sweeps``: one
launch of the sweep kernel for walkers on the card, the plain PyTorch
version for walkers on the CPU. Each sweep draws its own (n_sites, K)
block of acceptance uniforms from the state's generator, so memory does
not grow with the number of sweeps.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from neural_network_quantum_state_tpu_torch.ops import engine
from neural_network_quantum_state_tpu_torch.ops.engine import Cache, Work
from neural_network_quantum_state_tpu_torch.ops.rng import uniform_block
from neural_network_quantum_state_tpu_torch.ops.sweep import metropolis_sweeps


class MCState(NamedTuple):
    """Sampler state threaded through the steps."""

    cache: Cache  # spins / y / sa, all (K, ...)
    lnpsi: torch.Tensor  # (K,) complex: ln psi of the current states
    generator: torch.Generator  # on the walkers' device; advanced in place
    n_accepted: torch.Tensor  # () float64 counter on the walkers' device
    n_proposed: torch.Tensor  # () float64 counter


def init_state(work: Work, spins: torch.Tensor, generator: torch.Generator) -> MCState:
    cache, lnpsi = engine.full_forward(work, spins)
    zero = torch.zeros((), dtype=torch.float64, device=spins.device)
    return MCState(cache=cache, lnpsi=lnpsi, generator=generator, n_accepted=zero, n_proposed=zero.clone())


def sweeps(work: Work, state: MCState, schedule: torch.Tensor, n_sweeps: int) -> MCState:
    """Run ``n_sweeps`` full sweeps over the site schedule, one
    ``metropolis_sweeps`` call (one kernel launch on the card) per sweep."""
    k, n_rounds = state.lnpsi.shape[0], schedule.shape[0]
    cache, lnpsi, n_acc = state.cache, state.lnpsi, state.n_accepted
    for _ in range(n_sweeps):
        uniforms = uniform_block(state.generator, (n_rounds, k), cache.spins.dtype)
        cache, lnpsi, acc = metropolis_sweeps(work, cache, lnpsi, schedule, uniforms)
        n_acc = n_acc + acc
    return MCState(
        cache=cache,
        lnpsi=lnpsi,
        generator=state.generator,
        n_accepted=n_acc,
        n_proposed=state.n_proposed + float(n_sweeps * n_rounds * k),
    )
