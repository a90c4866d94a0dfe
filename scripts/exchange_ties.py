#!/usr/bin/env python3
"""The float32 tempered exchange kernel's decisions against the plain version's, over fresh inputs, on one NVIDIA GPU.

    python3 scripts/exchange_ties.py [--seeds 0 1 2 ...] [--inputs FILE ...] [--n-beta 4 8] [--out FILE]

``chip_smoke.py`` phase 3 holds the tempered exchange kernel
(``csrc/exchange_tempered.cu``) to the plain tempered exchange
(``ops.exchange.tempered_exchange_plain``) over 5 sweeps in one launch on
its Philox stream, at the Hubbard flagship's shapes (the L = 32 trap,
``RBM(64, 64)`` with its init weights times 10, K = 4096), and fails where
more than 1e-3 of the walker rows (4 of 4096) end with other spins. This
script draws those inputs anew from each seed (params, start and key, in
that order from one generator), or loads them from a FILE written by
``torch.save`` ({"params": {w, b, a}, "spins", "key"}), and runs that check
at each n_beta. For every chain of n_beta rows in which the kernel and the
plain version part it finds the first sweep after which they differ
(kernel launches of 1 to 5 sweeps on the same stream draw the same numbers)
and, along the plain version's own path through that sweep (its rounds
replayed here as ``exchange_plain`` and ``swap_phase`` take them, and
checked against ``tempered_exchange_plain``), the decision of the chain's
rows with the smallest margin: a proposal's |ln u - 2 beta min(dln, 0)|, a
swap's |ln u - 2/n_beta min(dln, 0)|, beside the float32 rounding of its dln
(|dln in float32 - dln in float64| at the same configurations). A margin
of a few times that rounding is a near-tie: the kernel and the plain
version sum the float32 log-cosh terms of dln in other orders, and either
may fall on either side. For scale it counts, over all rows and sweeps, the
decisions whose margin is below 4 times their rounding. Prints a line per
(input, n_beta) and per parting chain, and, last, one JSON object of all of
it (also to --out). Exits 1 without a CUDA device. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SWEEPS, HUB_L, HUB_H, HUB_K, HUB_PARTICLES, HUB_TRAP, PARAM_SCALE = 5, 32, 64, 4096, 5, 0.05, 10.0
MISMATCH_MAX, NEAR = 1e-3, 4.0  # chip_smoke.py's EXCHANGE_MISMATCH_MAX; a near-tie's margin in roundings


def _inputs(torch, args, dev):
    """[(label, work, spins, key)] from the seeds and the files."""
    from neural_network_quantum_state_tpu_torch.hamiltonians import HubbardChain
    from neural_network_quantum_state_tpu_torch.models import RBM
    from neural_network_quantum_state_tpu_torch.ops.rng import make_generator, philox_key

    hub_v = tuple(float(x) for x in [HUB_TRAP * (i - (HUB_L - 1) / 2.0) ** 2 for i in range(HUB_L)] * 2)
    ham = HubbardChain(n_sites=2 * HUB_L, u=4.0, t=1.0, n_up=HUB_PARTICLES, n_down=HUB_PARTICLES, pbc=True, v=hub_v)
    machine = RBM(n_inputs=2 * HUB_L, n_hiddens=HUB_H)
    out = []
    for seed in args.seeds:
        g = make_generator(seed, dev)
        params = {k: PARAM_SCALE * v for k, v in machine.init_params(g).items()}
        out.append((f"seed {seed}", machine.make_work(params), ham.init_spins(g, HUB_K), philox_key(g)))
    for path in args.inputs:
        saved = torch.load(path, map_location=dev)
        out.append((Path(path).name, machine.make_work(saved["params"]), saved["spins"], saved["key"]))
    return ham, out


def _plain_path(torch, work, spins, bonds, draws, n_beta, n_unit):
    """The plain tempered exchange along its own path, sweep by sweep:
    [(state after the sweep, (K,) smallest margin of a row's decisions in
    the sweep, the float32 rounding of that decision's dln)], and the number
    of decisions within NEAR roundings of a tie."""
    from neural_network_quantum_state_tpu_torch.ops import engine
    from neural_network_quantum_state_tpu_torch.ops.exchange import select_active_bond
    from neural_network_quantum_state_tpu_torch.ops.sweep import replica_betas, swap_phase

    k = spins.shape[0]
    w64 = engine.Work(*(None if t is None else t.to(torch.complex128) for t in work))
    cache, lnpsi = engine.full_forward(work, spins)
    u_sel, u_acc = draws.selection(k), draws.acceptance(k)
    u_swap = draws.swaps(SWEEPS, k) if n_beta > 1 else None
    beta = replica_betas(n_beta, k // n_beta, spins.dtype, spins.device)
    b = bonds.long()
    path, near = [], 0
    for s in range(SWEEPS):
        best = torch.full((k,), float("inf"), dtype=torch.float64, device=spins.device)
        err = torch.zeros_like(best)

        def note(margin, rounding, rows):
            nonlocal near
            near += int(((margin < NEAR * rounding) & rows).sum())
            better = rows & (margin < best)
            best.copy_(torch.where(better, margin, best))
            err.copy_(torch.where(better, rounding, err))

        for t in range(s * n_unit, (s + 1) * n_unit):  # exchange_plain's round, its margins beside it
            sp = cache.spins
            active = sp[:, b[:, 0]] * sp[:, b[:, 1]] < 0
            bond, nb = select_active_bond(active, u_sel[t])
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
        path.append((cache, best, err))
    return path, near


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="*", default=list(range(8)))
    ap.add_argument("--inputs", nargs="*", default=[])
    ap.add_argument("--n-beta", type=int, nargs="+", default=[4, 8])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("exchange_ties: no CUDA device", file=sys.stderr)
        return 1
    from neural_network_quantum_state_tpu_torch.ops import engine
    from neural_network_quantum_state_tpu_torch.ops.exchange import exchange_cuda, tempered_exchange_plain
    from neural_network_quantum_state_tpu_torch.ops.rng import ExchangeDraws

    dev = torch.device("cuda")
    ham, inputs = _inputs(torch, args, dev)
    bonds = torch.as_tensor(ham.bonds, device=dev)
    n_unit = ham.n_unit_steps
    results = []
    for label, work, spins, key in inputs:
        for nb in args.n_beta:
            draws = ExchangeDraws(key, SWEEPS * n_unit)
            cache, lnpsi = engine.full_forward(work, spins)
            kernel = [exchange_cuda(work, cache, bonds, ExchangeDraws(key, s * n_unit), n_beta=nb, n_unit=n_unit)[0]
                      for s in range(1, SWEEPS + 1)]
            want, _, _ = tempered_exchange_plain(work, cache, lnpsi, bonds, draws, n_beta=nb, n_unit=n_unit)
            path, near = _plain_path(torch, work, spins, bonds, draws, nb, n_unit)
            if not torch.equal(path[-1][0].spins, want.spins):
                raise SystemExit("exchange_ties: the replayed plain path is not tempered_exchange_plain's")
            apart = [(ck.spins != pc.spins).any(1) for ck, (pc, _, _) in zip(kernel, path)]
            rows = int(apart[-1].sum())
            chains = []
            for c in sorted(set((torch.nonzero(torch.stack(apart).any(0)).flatten() // nb).tolist())):
                sl = slice(c * nb, (c + 1) * nb)
                first = next(s for s in range(SWEEPS) if bool(apart[s][sl].any()))
                _, best, err = path[first]
                m = int(torch.argmin(best[sl]))
                chains.append({"chain": c, "rows_apart_at_end": int(apart[-1][sl].sum()), "first_sweep": first + 1,
                               "margin": float(best[sl][m]), "rounding": float(err[sl][m]),
                               "margin_in_roundings": float(best[sl][m] / err[sl][m]) if err[sl][m] > 0 else None})
                print(f"{label} n_beta={nb} chain {c}: apart after sweep {first + 1}, its smallest margin "
                      f"{chains[-1]['margin']:.3e} against a rounding of dln of {chains[-1]['rounding']:.3e}",
                      flush=True)
            entry = {"input": label, "n_beta": nb, "rows_apart": rows, "share": rows / HUB_K,
                     "passes": rows / HUB_K <= MISMATCH_MAX, "chains_apart": len(chains),
                     "near_tie_decisions": near, "chains": chains}
            print(f"{label} n_beta={nb}: rows apart {rows}/{HUB_K} = {rows / HUB_K:.2e} (max {MISMATCH_MAX:.0e}), "
                  f"chains apart {len(chains)}; decisions within {NEAR:g} roundings of a tie on the plain path: "
                  f"{near}", flush=True)
            results.append(entry)
    line = json.dumps({"exchange_ties": results})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
