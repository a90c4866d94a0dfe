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

``tempered_exchange_sweeps`` is parallel tempering with this move class
(the JAX package's composition; its PT machinery shared with
``sampler/tempering.py``): the replica-minor layout (walker
w = k * n_beta + r at beta_r = (n_beta - r) / n_beta), each sweep of
``n_unit_steps`` proposals at the walker's beta followed by the even-pair
and the odd-pair swap phase. A swap exchanges whole configurations between
replicas of one chain, so every replica keeps its particle numbers. On the
card one call is one launch of the exchange kernel's tempered instance, the
swap uniforms on their own stream of the call's key; on the CPU each sweep
is one plain call on (n_unit_steps, K) selection and acceptance blocks and
two (K,) swap blocks from the state's generator.
``exchange_swap_acceptance_probe`` and ``tune_n_beta_exchange`` are the
ladder diagnostics of ``tempering.swap_acceptance_probe`` and
``tempering.tune_n_beta`` with this move class.

A state sharded over a walker mesh runs each call once per shard, as the
JAX package's ``make_fused_exchange_sharded_sweeps`` does: on the card one
launch per shard on the call's key at the shard's first global walker row,
on the CPU each shard on its columns of the call's blocks
(``sampler/metropolis.py``); a shard holds whole replica groups, so its
swaps stay in the shard.

Lattice topologies:
- ring_bonds(n): one ring over all inputs; exchanges may cross the up/down
  boundary (conserves the total particle number only).
- two_ring_bonds(l): two independent rings for the spin-up [0, L) and
  spin-down [L, 2L) inputs (conserves each flavor's particle number).
"""

from __future__ import annotations

import numpy as np
import torch

from neural_network_quantum_state_tpu_torch.ops.engine import Cache, Work
from neural_network_quantum_state_tpu_torch.ops.exchange import exchange_steps
from neural_network_quantum_state_tpu_torch.ops.rng import ExchangeDraws, philox_key, uniform_block
from neural_network_quantum_state_tpu_torch.parallel.mesh import gather, shard_map, split, split_draws
from neural_network_quantum_state_tpu_torch.sampler.metropolis import MCState


def ring_bonds(n: int) -> np.ndarray:
    """(n, 2) int32 spin indices of ring bonds b: (b, (b+1) % n)."""
    b = np.arange(n)
    return np.stack([b, (b + 1) % n], axis=1).astype(np.int32)


def two_ring_bonds(l: int) -> np.ndarray:
    """(2L, 2) int32 bonds of two independent rings: up [0, L), down [L, 2L)."""
    up = ring_bonds(l)
    return np.concatenate([up, up + l], axis=0).astype(np.int32)


def exchange_calls(work: Work, cache: Cache, lnpsi: torch.Tensor, bonds: torch.Tensor, n_sweeps: int, n_unit: int,
                   n_beta: int, g: torch.Generator):
    """``n_sweeps`` sweeps of ``n_unit`` exchange proposals (each with its
    swap phases for n_beta > 1): on the card one ``exchange_steps`` call, one
    kernel launch on one Philox key, for all of them; on the CPU one call per
    sweep on its uniform blocks (selection, acceptance, then the two swap
    phases'). Returns (cache, lnpsi, counts), counts the summed (2, K)
    per-row counts of ``ops.exchange.exchange_steps``. A sharded state runs
    one call per shard on its columns of the blocks, or on the call's key at
    its rows."""
    k = lnpsi.shape[0]
    total = torch.zeros((2, k), dtype=torch.float64, device=lnpsi.device)
    if cache.spins.device.type == "cpu":
        dtype = cache.spins.dtype
        for _ in range(n_sweeps):
            u_sel = uniform_block(g, (n_unit, k), dtype)
            u_acc = uniform_block(g, (n_unit, k), dtype)
            swaps = None
            if n_beta > 1:
                swaps = torch.stack([uniform_block(g, (k,), dtype), uniform_block(g, (k,), dtype)])[None]
            u_sel, u_acc, swaps = split(u_sel, lnpsi, 1), split(u_acc, lnpsi, 1), split(swaps, lnpsi, 2)
            cache, lnpsi, counts = shard_map(exchange_steps, work, cache, lnpsi, bonds, u_sel, u_acc, n_beta, n_unit,
                                             swaps)
            total += gather(counts, dim=1)
    elif n_sweeps * n_unit > 0:
        draws = split_draws(ExchangeDraws(philox_key(g), n_sweeps * n_unit), lnpsi)
        cache, lnpsi, counts = shard_map(exchange_steps, work, cache, lnpsi, bonds, draws, None, n_beta, n_unit)
        total = gather(counts, dim=1)
    return cache, lnpsi, total


def exchange_sweeps(work: Work, state: MCState, bonds: torch.Tensor, n_sweeps: int, n_unit_steps: int) -> MCState:
    """Run ``n_sweeps`` sweeps of ``n_unit_steps`` exchange proposals each:
    one kernel launch for all of them on the card, one ``exchange_steps``
    call per sweep on the CPU. `bonds` is the (B, 2) int32 table on the
    walkers' device. The tempered sampler with one replica."""
    return tempered_exchange_sweeps(work, state, bonds, n_sweeps, n_unit_steps, 1)


def tempered_exchange_sweeps(work: Work, state: MCState, bonds: torch.Tensor, n_sweeps: int, n_unit_steps: int,
                             n_beta: int) -> MCState:
    """n_sweeps of (tempered exchange sweep + even swaps + odd swaps) in the
    replica-minor layout; the estimators read the beta = 1 slice
    [::n_beta]. ``n_sweeps <= 0`` returns the state unchanged (a no-op, as
    in the JAX package, whose fermion measurements warm later sites with
    none)."""
    if n_sweeps <= 0:
        return state
    k = state.lnpsi.shape[0]
    cache, lnpsi, counts = exchange_calls(work, state.cache, state.lnpsi, bonds, n_sweeps, n_unit_steps, n_beta,
                                          state.generator)
    return MCState(
        cache=cache,
        lnpsi=lnpsi,
        generator=state.generator,
        n_accepted=state.n_accepted + counts[0].sum(),
        n_proposed=state.n_proposed + float(n_sweeps * n_unit_steps * k),
    )


def exchange_swap_acceptance_probe(work: Work, state: MCState, bonds: torch.Tensor, n_sweeps: int, n_unit_steps: int,
                                   n_beta: int):
    """Measured ladder diagnostics over n_sweeps tempered exchange sweeps.

    Returns (pair_swap_acceptance (n_beta-1,), exchange_acceptance_per_replica
    (n_beta,), updated state), both in [0, 1], as the JAX package's probe:
    each adjacent pair is proposed once per sweep by each of the kb chains,
    and each replica makes n_unit_steps proposals per sweep per chain.
    """
    k = state.lnpsi.shape[0]
    kb = k // n_beta
    cache, lnpsi, counts = exchange_calls(work, state.cache, state.lnpsi, bonds, n_sweeps, n_unit_steps, n_beta,
                                          state.generator)
    per_replica = counts.reshape(2, kb, n_beta).sum(1)  # row w is replica w % n_beta
    new_state = MCState(
        cache=cache,
        lnpsi=lnpsi,
        generator=state.generator,
        n_accepted=state.n_accepted + per_replica[0].sum(),
        n_proposed=state.n_proposed + float(n_sweeps * n_unit_steps * k),
    )
    swap_rate = per_replica[1, : n_beta - 1] / float(n_sweeps * kb)
    ex_rate = per_replica[0] / float(n_sweeps * n_unit_steps * kb)
    return swap_rate, ex_rate, new_state


def tune_n_beta_exchange(
    work: Work,
    state: MCState,
    bonds: torch.Tensor,
    n_unit_steps: int,
    candidates: tuple[int, ...] = (2, 4, 6, 8, 12, 16),
    target: float = 0.2,
    mix_target: float = 0.1,
    warm_sweeps: int = 50,
    probe_sweeps: int = 25,
    n_devices: int = 1,
) -> tuple[int, dict[int, dict[str, list[float]]]]:
    """The smallest replica count whose measured ladder works, probed with
    the particle-conserving exchange dynamics (a flip probe would break the
    sector): every adjacent-pair swap acceptance >= target and the hottest
    replica's exchange acceptance >= mix_target, as ``tempering.tune_n_beta``.

    Candidates that do not divide the walker count (per device) are skipped;
    if none qualifies, the largest valid candidate is returned. Each
    candidate warms warm_sweeps tempered sweeps from `state` before its
    probe. diags[nb] = {"swap": [...], "flip": [...]}.
    """
    k = int(state.lnpsi.shape[0])
    diags: dict[int, dict[str, list[float]]] = {}
    best = None
    for nb in candidates:
        if nb < 2 or k % (nb * max(n_devices, 1)) != 0:
            continue
        st = tempered_exchange_sweeps(work, state, bonds, warm_sweeps, n_unit_steps, nb)
        swap_rate, ex_rate, _ = exchange_swap_acceptance_probe(work, st, bonds, probe_sweeps, n_unit_steps, nb)
        diags[nb] = {"swap": swap_rate.tolist(), "flip": ex_rate.tolist()}
        best = nb
        if min(diags[nb]["swap"]) >= target and max(diags[nb]["flip"]) >= mix_target:
            return nb, diags
    if best is None:
        raise ValueError(f"no n_beta candidate in {candidates} divides n_walkers={k} (x {n_devices} devices)")
    return best, diags
