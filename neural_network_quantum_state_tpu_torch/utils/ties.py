"""Near-ties of the tempered exchange: where the kernel and the plain
version may part without either being wrong.

A proposal of the (tempered) exchange is accepted where
``u < exp(2 beta min(dln, 0))`` and a swap where
``u < exp(2/n_beta min(dln, 0))``. The kernel and the plain version sum the
float32 log-cosh terms of dln in other orders, so a decision whose margin
|ln u - 2 beta min(dln, 0)| is within a few float32 roundings of its dln
(|dln in float32 - dln in float64| at the same configurations) may fall on
either side in either of them. Once a chain's rows part, the swap phases
carry the parted configuration along the chain, so one near-tie moves up to
n_beta rows. ``parting_chains`` finds, for each chain in which the kernel's
rows end apart from the plain version's, the first sweep after which they
differ (the kernel relaunched for 1, 2, ... sweeps on the same uniforms
draws the same numbers) and, along the plain version's own path through
that sweep, the chain's decision with the smallest margin beside its
rounding. A chain whose smallest margin there is within ``NEAR`` roundings
is a near-tie chain.
"""

from __future__ import annotations

import torch

from neural_network_quantum_state_tpu_torch.ops import engine
from neural_network_quantum_state_tpu_torch.ops.exchange import exchange_cuda, select_active_bond
from neural_network_quantum_state_tpu_torch.ops.rng import ExchangeDraws
from neural_network_quantum_state_tpu_torch.ops.sweep import replica_betas, swap_phase

NEAR = 4.0  # a near-tie's margin, in float32 roundings of its dln


def exchange_uniforms(uniforms, k: int, n_sweeps: int, n_beta: int):
    """(u_sel, u_acc, u_swap) of a call: ``uniforms`` an ``ExchangeDraws``
    (its streams made here) or the (u_sel, u_acc[, u_swap]) blocks; u_swap
    the (n_sweeps, 2, K) swap uniforms, None for n_beta = 1."""
    if isinstance(uniforms, ExchangeDraws):
        return (uniforms.selection(k), uniforms.acceptance(k),
                uniforms.swaps(n_sweeps, k) if n_beta > 1 else None)
    u_sel, u_acc, *rest = uniforms
    return u_sel, u_acc, rest[0] if rest and n_beta > 1 else None


def plain_margins(work, spins, bonds, uniforms, n_beta: int, n_unit: int, near: float = NEAR):
    """The plain tempered exchange along its own path, sweep by sweep, with
    the margin of every decision: [(spins after the sweep, (K,) smallest
    margin of a row's decisions in the sweep, the float32 rounding of that
    decision's dln)], and the number of decisions within ``near`` roundings
    of a tie. ``uniforms`` as ``exchange_uniforms`` takes them; the rounds
    are ``exchange_plain``'s and ``swap_phase``'s, so the last spins are
    ``tempered_exchange_plain``'s."""
    k = spins.shape[0]
    u_sel, u_acc, u_swap = uniforms
    n_sweeps = u_sel.shape[0] // n_unit
    w64 = engine.Work(*(None if t is None else t.to(torch.complex128) for t in work))
    cache, lnpsi = engine.full_forward(work, spins)
    beta = replica_betas(n_beta, k // n_beta, spins.dtype, spins.device)
    b = bonds.to(device=spins.device, dtype=torch.long)
    path, n_near = [], 0
    for s in range(n_sweeps):
        best = torch.full((k,), float("inf"), dtype=torch.float64, device=spins.device)
        err = torch.zeros_like(best)

        def note(margin, rounding, rows):
            nonlocal n_near
            n_near += int(((margin < near * rounding) & rows).sum())
            better = rows & (margin < best)
            best.copy_(torch.where(better, margin, best))
            err.copy_(torch.where(better, rounding, err))

        for t in range(s * n_unit, (s + 1) * n_unit):  # exchange_plain's round, its margins beside it
            sp = cache.spins
            bond, nb = select_active_bond(sp[:, b[:, 0]] * sp[:, b[:, 1]] < 0, u_sel[t])
            i, j = b[bond, 0], b[bond, 1]
            lnpsi1 = engine.flip2_log_psi_per_walker(work, cache, i, j)
            dln = lnpsi1.real - lnpsi.real
            accept = (u_acc[t] < torch.exp(2.0 * beta * torch.clamp(dln, max=0.0))) & (nb > 0)
            c64, l64 = engine.full_forward(w64, sp.double())
            dln64 = engine.flip2_log_psi_per_walker(w64, c64, i, j).real - l64.real
            margin = (torch.log(u_acc[t].double()) - 2.0 * beta.double() * torch.clamp(dln.double(), max=0.0)).abs()
            note(margin, 2.0 * beta.double() * (dln.double() - dln64).abs(), nb > 0)
            cache = engine.commit_flip2_per_walker(work, cache, i, j, accept)
            lnpsi = torch.where(accept, lnpsi1, lnpsi)
        for parity in (0, 1) if n_beta > 1 else ():
            idx = torch.arange(k, device=spins.device)
            r = idx % n_beta
            lower = ((r - parity) % 2 == 0) & (r >= parity) & (r + 1 < n_beta)
            partner = torch.where(lower, idx + 1, idx)
            _, l64 = engine.full_forward(w64, cache.spins.double())
            dln = (lnpsi.real[partner] - lnpsi.real).double()
            dln64 = l64.real[partner] - l64.real
            margin = (torch.log(u_swap[s, parity].double()) - 2.0 / n_beta * torch.clamp(dln, max=0.0)).abs()
            rounding = 2.0 / n_beta * (dln - dln64).abs()
            upper = torch.zeros_like(lower)
            upper[1:] = lower[:-1]  # the upper member takes its lower's decision
            note(torch.where(upper, margin.roll(1), margin), torch.where(upper, rounding.roll(1), rounding),
                 lower | upper)
            cache, lnpsi, _ = swap_phase(cache, lnpsi, u_swap[s, parity], parity, n_beta)
        path.append((cache.spins, best, err))
    return path, n_near


def kernel_sweeps(work, cache, bonds, uniforms, n_beta: int, n_unit: int, n_sweeps: int) -> list:
    """The exchange kernel's spins after 1, ..., n_sweeps sweeps from the
    same start on the same uniforms (one launch each: an ``ExchangeDraws``
    of fewer rounds draws the same numbers first)."""
    out = []
    for s in range(1, n_sweeps + 1):
        if isinstance(uniforms, ExchangeDraws):
            args, swaps = (ExchangeDraws(uniforms.key, s * n_unit, uniforms.row0),), None
        else:
            u_sel, u_acc, u_swap = exchange_uniforms(uniforms, 0, n_sweeps, n_beta)
            args, swaps = (u_sel[: s * n_unit], u_acc[: s * n_unit]), None if u_swap is None else u_swap[:s]
        out.append(exchange_cuda(work, cache, bonds, *args, n_beta=n_beta, n_unit=n_unit,
                                 swap_uniforms=swaps)[0].spins)
    return out


def parting_chains(path, kernel_spins: list, n_beta: int, near: float = NEAR) -> list[dict]:
    """For every chain of n_beta rows whose rows end apart between the
    kernel's spins after each sweep (``kernel_spins``) and the plain path
    (``plain_margins``): its first parting sweep, the rows apart at the end,
    the smallest margin of its decisions in that sweep, that decision's
    rounding, their ratio, and whether that is a near-tie."""
    apart = torch.stack([(ks != ps).any(1) for ks, (ps, _, _) in zip(kernel_spins, path)])
    chains = []
    for c in sorted(set((torch.nonzero(apart.any(0)).flatten() // n_beta).tolist())):
        rows = slice(c * n_beta, (c + 1) * n_beta)
        first = next(s for s in range(len(path)) if bool(apart[s, rows].any()))
        _, best, err = path[first]
        m = int(torch.argmin(best[rows]))
        margin, rounding = float(best[rows][m]), float(err[rows][m])
        ratio = margin / rounding if rounding > 0 else (0.0 if margin == 0 else None)  # None: no rounding
        chains.append({"chain": c, "rows_apart_at_end": int(apart[-1, rows].sum()), "first_sweep": first + 1,
                       "margin": margin, "rounding": rounding, "margin_in_roundings": ratio,
                       "near_tie": ratio is not None and ratio < near})
    return chains


def find_ties(work, cache, bonds, uniforms, n_beta: int, n_unit: int, near: float = NEAR):
    """``parting_chains`` of the kernel against the plain tempered exchange
    from ``cache`` on ``uniforms`` (an ``ExchangeDraws`` or the (u_sel,
    u_acc, u_swap) blocks) in sweeps of ``n_unit`` proposals; returns
    (chains, the plain path's decisions within ``near`` roundings of a tie,
    the plain path's final spins, the kernel's). Launches the kernel once
    per sweep."""
    k = cache.spins.shape[0]
    n_steps = uniforms.n_steps if isinstance(uniforms, ExchangeDraws) else uniforms[0].shape[0]
    n_sweeps = n_steps // n_unit
    blocks = exchange_uniforms(uniforms, k, n_sweeps, n_beta)
    path, n_near = plain_margins(work, cache.spins, bonds, blocks, n_beta, n_unit, near)
    kernel = kernel_sweeps(work, cache, bonds, uniforms, n_beta, n_unit, n_sweeps)
    return parting_chains(path, kernel, n_beta, near), n_near, path[-1][0], kernel[-1]


NEAR_CHAINS_MAX = 0.01  # near-tie chains, as a share of all chains


def tie_gate(chains: list[dict], differ: torch.Tensor, n_beta: int, mismatch_max: float) -> dict:
    """The gate of a float32 tempered exchange check by chain: the rows
    apart (``differ``, (K,)) of chains that are not near-tie chains count
    against ``mismatch_max`` of the rows; the near-tie chains (``chains`` from
    ``parting_chains``) against ``NEAR_CHAINS_MAX`` of the chains. Returns
    the counts, the (K,) mask of the near-tie chains' rows and whether the
    check passes."""
    k = differ.shape[0]
    near = torch.zeros(k, dtype=torch.bool, device=differ.device)
    for ch in chains:
        if ch["near_tie"]:
            near[ch["chain"] * n_beta:(ch["chain"] + 1) * n_beta] = True
    other = int((differ & ~near).sum())
    n_near = sum(ch["near_tie"] for ch in chains)
    return {"rows_apart": int(differ.sum()), "other_rows": other, "near_tie_chains": n_near,
            "chains": k // n_beta, "near_rows": near,
            "passes": other <= mismatch_max * k and n_near <= NEAR_CHAINS_MAX * (k // n_beta)}
