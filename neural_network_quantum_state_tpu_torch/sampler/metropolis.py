"""Vectorized single-spin-flip Metropolis sampler.

K walkers advance in lock-step through the site schedule. One sweep is
len(schedule) proposal rounds, each:

    lnpsi1 = flip ln psi          (O(K*H) incremental update)
    accept = u < min(1, exp(2 Re(lnpsi1 - lnpsi0)))
    masked commit of y, sa and the spin

``sweeps`` runs through ``ops.sweep.metropolis_sweeps``. On the card a
whole call (a warm-up's 100 or 500 sweeps, a step's sweeps) is ONE launch
of the sweep kernel on one Philox key drawn from the state's generator, the
kernel drawing its uniforms on the chip (with n_beta > 1, parallel
tempering, ``sampler/tempering.py``, the swap phases after each sweep run
inside that launch), and ln psi is recomputed once per call, as the JAX
package's fused sweeps do. On the CPU each sweep stays one plain call on
its own (n_sites, K) block of acceptance uniforms from the generator, and
with n_beta > 1 a (1, 2, K) block for its two swap phases, so memory does
not grow with the number of sweeps (``sweep_draws``). The two streams
differ: a run on the card is reproducible from its seed, but does not take
the CPU run's numbers.

``block_flip_moves`` adds symmetric block flips (an ergodicity move), and
``acceptance_ratio`` reads and resets the counters.

A state sharded over a walker mesh (``parallel/mesh.py``: its cache and ln
psi ``Sharded``) runs every call once per shard, as the JAX package's
``make_fused_sharded_sweeps`` does under ``shard_map``: on the card one
kernel launch per shard on the call's one key, each shard at its first
global walker row; on the CPU each shard takes its columns of the call's
uniform blocks. Either way a sharded run makes the unsharded run's
decisions, and the acceptance counters sum over the shards.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from neural_network_quantum_state_tpu_torch.ops import engine
from neural_network_quantum_state_tpu_torch.ops.engine import Cache, Work
from neural_network_quantum_state_tpu_torch.ops.rng import PhiloxDraws, philox_key, uniform_block
from neural_network_quantum_state_tpu_torch.ops.sweep import metropolis_sweeps
from neural_network_quantum_state_tpu_torch.parallel.mesh import gather, reduce_sum, shard_map, split, split_draws


class MCState(NamedTuple):
    """Sampler state threaded through the steps; on a walker mesh the cache
    and ln psi are ``Sharded`` (``parallel.mesh.shard_walker_tree``)."""

    cache: Cache  # spins / y / sa, all (K, ...)
    lnpsi: torch.Tensor  # (K,) complex: ln psi of the current states
    generator: torch.Generator  # on the walkers' device; advanced in place
    n_accepted: torch.Tensor  # () float64 counter on the walkers' device
    n_proposed: torch.Tensor  # () float64 counter


def init_state(work: Work, spins: torch.Tensor, generator: torch.Generator) -> MCState:
    """The state of walkers ``spins`` (a tensor, or ``Sharded`` spins: a
    sharded state)."""
    cache, lnpsi = shard_map(engine.full_forward, work, spins)
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


def _sharded_sweeps(work: Work, cache: Cache, lnpsi, schedule, uniforms, n_beta: int, swaps, rows: bool):
    """``metropolis_sweeps`` once per shard of a sharded state (the walkers'
    columns of caller uniforms, or the call's Philox key at each shard's
    rows); an unsharded state's one call. The counts come back summed, or
    with ``rows=True`` as the (2, K) rows of all shards in walker order."""
    like = lnpsi
    if isinstance(uniforms, PhiloxDraws):
        uniforms = split_draws(uniforms, like)
    else:
        uniforms, swaps = split(uniforms, like, dim=1), split(swaps, like, dim=2)
    cache, lnpsi, acc = shard_map(metropolis_sweeps, work, cache, lnpsi, schedule, uniforms, n_beta, swaps, rows)
    return cache, lnpsi, gather(acc, dim=1) if rows else reduce_sum(acc)


def sweep_calls(work: Work, cache: Cache, lnpsi: torch.Tensor, schedule: torch.Tensor, n_sweeps: int,
                n_beta: int, g: torch.Generator, rows: bool = False):
    """``n_sweeps`` sweeps (each with its swap phases for n_beta > 1): on the
    card one ``metropolis_sweeps`` call, one kernel launch on one Philox
    key, for all of them (one launch per shard of a sharded state, on that
    key); on the CPU one call per sweep on its uniform blocks. Returns
    (cache, lnpsi, accepted flips), or with ``rows=True`` the summed (2, K)
    per-row counts of ``ops.sweep.sweep_plain``."""
    n_rounds = schedule.shape[0]
    total = torch.zeros((2, lnpsi.shape[0]) if rows else (), dtype=torch.float64, device=lnpsi.device)
    if cache.spins.device.type == "cpu":
        for _ in range(n_sweeps):
            uniforms, swaps = sweep_draws(g, cache.spins, n_rounds, n_beta)
            cache, lnpsi, acc = _sharded_sweeps(work, cache, lnpsi, schedule, uniforms, n_beta, swaps, rows)
            total = total + acc
    elif n_sweeps > 0:
        draws = PhiloxDraws(philox_key(g), n_sweeps * n_rounds)
        cache, lnpsi, acc = _sharded_sweeps(work, cache, lnpsi, schedule, draws, n_beta, None, rows)
        total = total + acc
    return cache, lnpsi, total


def sweeps(work: Work, state: MCState, schedule: torch.Tensor, n_sweeps: int, n_beta: int = 1) -> MCState:
    """Run ``n_sweeps`` full sweeps over the site schedule, with n_beta > 1
    each followed by its replica-exchange phases (``sweep_calls``: one
    kernel launch on the card)."""
    k, n_rounds = state.lnpsi.shape[0], schedule.shape[0]
    cache, lnpsi, acc = sweep_calls(work, state.cache, state.lnpsi, schedule, n_sweeps, n_beta, state.generator)
    return MCState(
        cache=cache,
        lnpsi=lnpsi,
        generator=state.generator,
        n_accepted=state.n_accepted + acc,
        n_proposed=state.n_proposed + float(n_sweeps * n_rounds * k),
    )


def block_flip_moves(work: Work, state: MCState, n_moves: int = 1, max_block: int | None = None,
                     beta: torch.Tensor | None = None) -> MCState:
    """Symmetric block-flip proposals: per walker, flip the contiguous block
    of sites [i, i + l) (periodic wrap) with i ~ U[0, N) and
    l ~ U[1, max_block] (default N // 2), one full forward per move.

    Re-drawing the same (i, l) reverses a move, so Metropolis acceptance
    min(1, |psi'/psi|^2) preserves |psi|^2, or the tempered |psi|^(2 beta)
    with a per-walker ``beta`` (the replica layout of
    ``ops.sweep.replica_betas``). An ergodicity move beyond the reference's
    single flips: where those freeze in a deep-ordered phase, a block flip
    can hop between ordered sectors. The accepts are not counted in the
    single-flip acceptance counters (the reference's convention). A move's
    draws are made for all K walkers; a sharded state's shards take their
    rows of them."""
    k, n = state.cache.spins.shape
    if max_block is None:
        max_block = max(n // 2, 1)
    g, dev = state.generator, state.cache.spins.device
    cache, lnpsi0 = state.cache, state.lnpsi
    beta = split(beta, lnpsi0)
    for _ in range(n_moves):
        i0 = torch.randint(0, n, (k,), generator=g, device=dev)
        ell = torch.randint(1, max_block + 1, (k,), generator=g, device=dev)
        u = uniform_block(g, (k,), cache.spins.dtype)
        draws = [split(x, lnpsi0) for x in (i0, ell, u)]
        cache, lnpsi0 = shard_map(_block_flip, work, cache, lnpsi0, *draws, beta)
    return state._replace(cache=cache, lnpsi=lnpsi0)


def _block_flip(work: Work, cache: Cache, lnpsi0: torch.Tensor, i0: torch.Tensor, ell: torch.Tensor,
                u: torch.Tensor, beta: torch.Tensor | None):
    """One block-flip move of ``block_flip_moves`` on its drawn (i0, ell, u)."""
    n = cache.spins.shape[1]
    sites = torch.arange(n, device=cache.spins.device)
    mask = (sites[None, :] - i0[:, None]) % n < ell[:, None]
    cache1, lnpsi1 = engine.full_forward(work, torch.where(mask, -cache.spins, cache.spins))
    dln = lnpsi1.real - lnpsi0.real
    if beta is not None:
        dln = beta.to(dln.dtype) * dln
    accept = u < torch.exp(2.0 * torch.clamp(dln, max=0.0))
    cache = Cache(*(torch.where(accept.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)
                    for new, old in zip(cache1, cache)))
    return cache, torch.where(accept, lnpsi1, lnpsi0)


def acceptance_ratio(state: MCState) -> tuple[torch.Tensor, MCState]:
    """Read-and-reset acceptance ratio: accepted / max(proposed, 1), and the
    state with both counters at zero."""
    ratio = state.n_accepted / torch.clamp(state.n_proposed, min=1.0)
    zero = torch.zeros_like(state.n_accepted)
    return ratio, state._replace(n_accepted=zero, n_proposed=zero.clone())
