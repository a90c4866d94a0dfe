#!/usr/bin/env python3
"""The float32 tempered exchange kernel's decisions against the plain version's, over fresh inputs, on one NVIDIA GPU.

    python3 scripts/exchange_ties.py [--seeds 0 1 2 ...] [--inputs FILE ...] [--n-beta 4 8] [--out FILE]

``chip_smoke.py`` phase 3 holds the tempered exchange kernel
(``csrc/exchange_tempered.cu``) to the plain tempered exchange
(``ops.exchange.tempered_exchange_plain``) over 5 sweeps in one launch on
its Philox stream, at the Hubbard flagship's shapes (the L = 32 trap,
``RBM(64, 64)`` with its init weights times 10, K = 4096), by chain:
the rows of chains that part at a near-tie are set apart (at most 1% of
the chains may), the other parting chains' rows count against 1e-3 of the
rows (4 of 4096). This script draws those inputs anew from each seed
(params, start and key, in that order from one generator), or loads them
from a FILE written by ``torch.save`` ({"params": {w, b, a}, "spins",
"key"}), and runs that check at each n_beta through the package's finder
(``neural_network_quantum_state_tpu_torch/utils/ties.py``): for every chain
of n_beta rows in which the kernel and the plain version part, the first
sweep after which they differ (kernel launches of 1 to 5 sweeps on the same
stream draw the same numbers) and, along the plain version's own path
through that sweep (checked here against ``tempered_exchange_plain``), the
decision of the chain's rows with the smallest margin: a proposal's
|ln u - 2 beta min(dln, 0)|, a swap's |ln u - 2/n_beta min(dln, 0)|,
beside the float32 rounding of its dln (|dln in float32 - dln in float64|
at the same configurations). A margin of fewer than 4 such roundings is a
near-tie: the kernel and the plain version sum the float32 log-cosh terms
of dln in other orders, and either may fall on either side. For scale it
counts, over all rows and sweeps, the decisions within 4 roundings of a
tie. Prints a line per (input, n_beta) and per parting chain, with both
the old gate by rows and the gate by chain, and, last, one JSON object of
all of it (also to --out). Exits 1 without a CUDA device. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SWEEPS, HUB_L, HUB_H, HUB_K, HUB_PARTICLES, HUB_TRAP, PARAM_SCALE = 5, 32, 64, 4096, 5, 0.05, 10.0
MISMATCH_MAX = 1e-3  # chip_smoke.py's EXCHANGE_MISMATCH_MAX


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
    from neural_network_quantum_state_tpu_torch.ops.exchange import tempered_exchange_plain
    from neural_network_quantum_state_tpu_torch.ops.rng import ExchangeDraws
    from neural_network_quantum_state_tpu_torch.utils import ties

    dev = torch.device("cuda")
    ham, inputs = _inputs(torch, args, dev)
    bonds = torch.as_tensor(ham.bonds, device=dev)
    n_unit = ham.n_unit_steps
    results = []
    for label, work, spins, key in inputs:
        for nb in args.n_beta:
            draws = ExchangeDraws(key, SWEEPS * n_unit)
            cache, lnpsi = engine.full_forward(work, spins)
            want, _, _ = tempered_exchange_plain(work, cache, lnpsi, bonds, draws, n_beta=nb, n_unit=n_unit)
            chains, near, plain_end, kernel_end = ties.find_ties(work, cache, bonds, draws, nb, n_unit)
            if not torch.equal(plain_end, want.spins):
                raise SystemExit("exchange_ties: the replayed plain path is not tempered_exchange_plain's")
            gate = ties.tie_gate(chains, (kernel_end != want.spins).any(1), nb, MISMATCH_MAX)
            for ch in chains:
                print(f"{label} n_beta={nb} chain {ch['chain']}: apart after sweep {ch['first_sweep']}, its smallest "
                      f"margin {ch['margin']:.3e} against a rounding of dln of {ch['rounding']:.3e}"
                      + (" (a near-tie)" if ch["near_tie"] else ""), flush=True)
            rows = gate["rows_apart"]
            entry = {"input": label, "n_beta": nb, "rows_apart": rows, "share": rows / HUB_K,
                     "passes_rows": rows / HUB_K <= MISMATCH_MAX, "passes_gate": gate["passes"],
                     "other_rows": gate["other_rows"], "near_tie_chains": gate["near_tie_chains"],
                     "chains_apart": len(chains), "near_tie_decisions": near, "chains": chains}
            print(f"{label} n_beta={nb}: rows apart {rows}/{HUB_K} = {rows / HUB_K:.2e} (max {MISMATCH_MAX:.0e}), "
                  f"chains apart {len(chains)}, near-tie chains {gate['near_tie_chains']}, other rows "
                  f"{gate['other_rows']}: the gate by chain {'passes' if gate['passes'] else 'fails'}; decisions "
                  f"within {ties.NEAR:g} roundings of a tie on the plain path: {near}", flush=True)
            results.append(entry)
    line = json.dumps({"exchange_ties": results})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
