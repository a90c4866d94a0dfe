"""Vectorized single-spin-flip Metropolis sampler.

K walkers advance in lock-step through the site schedule. One sweep is
len(schedule) proposal rounds, each:

    lnpsi1 = flip ln psi          (O(K*H) incremental update)
    accept = u < min(1, exp(2 Re(lnpsi1 - lnpsi0)))
    masked commit of y, sa and the spin

``sweeps`` runs each sweep through ``ops.sweep.metropolis_sweeps``: one
launch of the sweep kernel for walkers on the card, the plain PyTorch
version for walkers on the CPU. On the CPU each sweep draws its own
(n_sites, K) block of acceptance uniforms from the state's generator, and
with n_beta > 1 (parallel tempering, ``sampler/tempering.py``) then a
(1, 2, K) block for its two swap phases, so memory does not grow with the
number of sweeps. On the card each sweep draws one Philox key from the
state's generator and the kernel draws its uniforms on the chip
(``sweep_draws``): a run on the card is reproducible from its seed, but does
not take the CPU run's numbers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from neural_network_quantum_state_tpu_torch.ops import engine
from neural_network_quantum_state_tpu_torch.ops.engine import Cache, Work
from neural_network_quantum_state_tpu_torch.ops.rng import PhiloxDraws, philox_key, uniform_block
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


def sweep_draws(g: torch.Generator, spins: torch.Tensor, n_rounds: int, n_beta: int):
    """The (uniforms, swap uniforms) of one sweep call of the walkers
    ``spins`` from the generator: on the CPU an (n_rounds, K) flip block and,
    with n_beta > 1, a (1, 2, K) swap block; on the card a fresh key for the
    kernel's Philox stream (``PhiloxDraws``, the swaps from the same stream)."""
    k = spins.shape[0]
    if spins.device.type != "cpu":
        return PhiloxDraws(philox_key(g), n_rounds), None
    uniforms = uniform_block(g, (n_rounds, k), spins.dtype)  # flips before swaps: the order fixes the CPU stream
    return uniforms, uniform_block(g, (1, 2, k), spins.dtype) if n_beta > 1 else None


def sweeps(work: Work, state: MCState, schedule: torch.Tensor, n_sweeps: int, n_beta: int = 1) -> MCState:
    """Run ``n_sweeps`` full sweeps over the site schedule, one
    ``metropolis_sweeps`` call (one kernel launch on the card) per sweep;
    with n_beta > 1 each sweep ends with its replica-exchange phases."""
    k, n_rounds = state.lnpsi.shape[0], schedule.shape[0]
    cache, lnpsi, n_acc = state.cache, state.lnpsi, state.n_accepted
    for _ in range(n_sweeps):
        uniforms, swaps = sweep_draws(state.generator, cache.spins, n_rounds, n_beta)
        cache, lnpsi, acc = metropolis_sweeps(work, cache, lnpsi, schedule, uniforms, n_beta, swaps)
        n_acc = n_acc + acc
    return MCState(
        cache=cache,
        lnpsi=lnpsi,
        generator=state.generator,
        n_accepted=n_acc,
        n_proposed=state.n_proposed + float(n_sweeps * n_rounds * k),
    )
