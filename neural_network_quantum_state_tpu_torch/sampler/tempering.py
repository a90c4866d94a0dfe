"""Replica-exchange (parallel tempering) Metropolis sampler.

n_beta replicas of K / n_beta chains each; beta_r = (n_beta - r)/n_beta.
One sweep is len(schedule) tempered flip rounds (accept prob
|exp(beta dlnpsi)|^2) followed by the even-pair then the odd-pair swap
phase between adjacent replicas (accept prob
|exp((beta_r - beta_{r+1}) (lnpsi_{r+1} - lnpsi_r))|^2).

The layout is the JAX package's replica-minor one: walker w = k*n_beta + r,
so each physical chain's replicas are adjacent and the estimators read the
beta = 1 replicas as the strided slice ``[::n_beta]``. On the card a whole
sampler call is one launch of the sweep kernel, which runs the swap phases
in the kernel; on the CPU each sweep is one call of the plain rounds and
swap phase (``_tempered_flip_rounds``, ``_swap_phase``, held in
``ops/sweep.py`` beside the kernel they mirror). Every draw comes from the
state's generator (``metropolis.sweep_calls``): on the CPU one (n_sites, K)
flip block and one (1, 2, K) swap block per sweep, on the card one key of
the kernel's Philox stream per call.
"""

from __future__ import annotations

import torch

from neural_network_quantum_state_tpu_torch.ops.engine import Work
from neural_network_quantum_state_tpu_torch.ops.sweep import replica_betas
from neural_network_quantum_state_tpu_torch.ops.sweep import swap_phase as _swap_phase
from neural_network_quantum_state_tpu_torch.ops.sweep import tempered_flip_rounds as _tempered_flip_rounds
from neural_network_quantum_state_tpu_torch.sampler.metropolis import MCState, sweep_calls, sweeps

__all__ = ["replica_betas", "swap_acceptance_probe", "tempering_sweeps", "tune_n_beta",
           "_swap_phase", "_tempered_flip_rounds"]


def tempering_sweeps(work: Work, state: MCState, schedule: torch.Tensor, n_sweeps: int, n_beta: int) -> MCState:
    """n_sweeps of (flip sweep + even swaps + odd swaps); the walker count
    must be a multiple of n_beta (walker k holds chain k // n_beta at
    replica k % n_beta)."""
    if state.lnpsi.shape[0] % n_beta != 0:
        raise ValueError(f"tempering: n_walkers ({state.lnpsi.shape[0]}) must be a multiple of n_beta ({n_beta})")
    return sweeps(work, state, schedule, n_sweeps, n_beta)


def swap_acceptance_probe(work: Work, state: MCState, schedule: torch.Tensor, n_sweeps: int, n_beta: int):
    """Measured ladder diagnostics over n_sweeps tempered sweeps.

    Returns (pair_swap_acceptance (n_beta-1,), flip_acceptance_per_replica
    (n_beta,), updated state), both in [0, 1], as the JAX package's probe:
    each adjacent pair is proposed once per sweep by each of the kb chains,
    so the swap denominator is n_sweeps * kb; the flip rate is the
    per-replica single-flip acceptance.
    """
    k = state.lnpsi.shape[0]
    if k % n_beta != 0:
        raise ValueError(f"tempering: n_walkers ({k}) must be a multiple of n_beta ({n_beta})")
    kb, n_rounds = k // n_beta, schedule.shape[0]
    cache, lnpsi, stats = sweep_calls(work, state.cache, state.lnpsi, schedule, n_sweeps, n_beta, state.generator,
                                      rows=True)
    per_replica = stats.reshape(2, kb, n_beta).sum(1)  # row w is replica w % n_beta
    new_state = MCState(
        cache=cache,
        lnpsi=lnpsi,
        generator=state.generator,
        n_accepted=state.n_accepted + per_replica[0].sum(),
        n_proposed=state.n_proposed + float(n_sweeps * n_rounds * k),
    )
    swap_rate = per_replica[1, : n_beta - 1] / float(n_sweeps * kb)
    flip_rate = per_replica[0] / float(n_sweeps * n_rounds * kb)
    return swap_rate, flip_rate, new_state


def tune_n_beta(
    work: Work,
    state: MCState,
    schedule: torch.Tensor,
    candidates: tuple[int, ...] = (2, 4, 6, 8, 12, 16),
    target: float = 0.2,
    mix_target: float = 0.1,
    warm_sweeps: int = 50,
    probe_sweeps: int = 25,
    n_devices: int = 1,
) -> tuple[int, dict[int, dict[str, list[float]]]]:
    """The smallest replica count whose ladder works, by two measured
    criteria: every adjacent-pair swap acceptance >= target, and the
    hottest replica's flip acceptance >= mix_target (on a collapsed
    ensemble adjacent replicas agree and swap trivially, so criterion 1
    alone would pass a ladder whose every replica is stuck).

    Candidates that do not divide the walker count (per device) are
    skipped; if none qualifies, the largest valid candidate is returned.
    Each candidate warms warm_sweeps tempered sweeps from `state` before
    its probe. diags[nb] = {"swap": [...], "flip": [...]}.
    """
    k = int(state.lnpsi.shape[0])
    diags: dict[int, dict[str, list[float]]] = {}
    best = None
    for nb in candidates:
        if nb < 2 or k % (nb * max(n_devices, 1)) != 0:
            continue
        st = tempering_sweeps(work, state, schedule, warm_sweeps, nb)
        swap_rate, flip_rate, _ = swap_acceptance_probe(work, st, schedule, probe_sweeps, nb)
        diags[nb] = {"swap": swap_rate.tolist(), "flip": flip_rate.tolist()}
        best = nb
        if min(diags[nb]["swap"]) >= target and max(diags[nb]["flip"]) >= mix_target:
            return nb, diags
    if best is None:
        raise ValueError(f"no n_beta candidate in {candidates} divides n_walkers={k} (x {n_devices} devices)")
    return best, diags
