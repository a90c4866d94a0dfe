"""Production-budget calibration of the hybrid increment-Renyi estimator on
the port.

The N = 12 cross-check inside ``renyi_cat_study`` runs the hybrid estimator
(a Z2-orbit-quadrature swap base at l0 = 1 and a glued increment chain) at
a light budget (60 iterations, 200 warm-up sweeps), too light to tell the
glue chain's equilibration from a real freeze bias. This calibration
repeats the measurement at the production budget of the N = 64 campaign
(800 iterations, 600 warm-up sweeps, 512 walkers a level, an n_beta = 4
tempered base) over several independent seeds, against the
exact-enumeration S2 of the trained state: each seed's estimate and pull
(est - exact)/err, and the mean bias over seeds with its standard error.

    python -m neural_network_quantum_state_tpu_torch.examples.renyi_inc_calibration [-L=12] [-nseed=4] [--device cpu]

Writes ``renyi_inc_calibration.json`` into ``--out``.
"""

from __future__ import annotations

import json
import math
import os
import sys

import numpy as np

from neural_network_quantum_state_tpu_torch.examples import common_args
from neural_network_quantum_state_tpu_torch.examples.renyi_cat_study import psi_of, s2_exact, train


def main(argv=None) -> dict:
    import torch

    from neural_network_quantum_state_tpu_torch.hamiltonians import LITFIChain
    from neural_network_quantum_state_tpu_torch.measurements import AmplitudeSampler, renyi2_increment
    from neural_network_quantum_state_tpu_torch.measurements.renyi_increment import swap_base_z2
    from neural_network_quantum_state_tpu_torch.models import RBMTrSymm
    from neural_network_quantum_state_tpu_torch.utils.cli import DriverArgs

    ns, rest = common_args(sys.argv[1:] if argv is None else argv, __doc__.splitlines()[0])
    args = DriverArgs(
        rest,
        options=[
            ("L", "chain length (ED-reachable)"),
            ("theta", "J = sin(theta), h = -cos(theta)"),
            ("alpha", "long-range decay exponent alpha_J"),
            ("nf", "RBM filters per ansatz"),
            ("niter", "measurement iterations (production: 800)"),
            ("nwarm", "measurement warm-up sweeps (production: 600)"),
            ("ns", "glue walkers per level (production: 512)"),
            ("nseed", "number of independent measurement seeds"),
            ("seed", "training seed"),
            ("ntrain", "SR iterations of the training"),
        ],
        defaults={"L": "12", "theta": "1.57", "alpha": "2.5", "nf": "4", "niter": "800", "nwarm": "600", "ns": "512",
                  "nseed": "4", "seed": "1", "ntrain": "1500"},
        prog="renyi_inc_calibration",
    )
    dev = ns.device
    n = args.find("L", int)
    l = n // 2
    theta = args.find("theta", float)
    niter, nwarm = args.find("niter", int), args.find("nwarm", int)
    n_glue, nseed = args.find("ns", int), args.find("nseed", int)
    j, h = math.sin(theta), -math.cos(theta)

    machine = RBMTrSymm(n_inputs=n, alpha=args.find("nf", int), dtype=torch.float64)
    ham = LITFIChain(n_sites=n, h=h, j=j, alpha=args.find("alpha", float), pbc=True)
    params, e = train(machine, ham, args.find("seed", int), args.find("ntrain", int), 1024, True, device=dev)
    exact = s2_exact(psi_of(machine, params), n, l)
    print(f"# trained RBMTrSymm N={n} theta={theta}: E/site = {e:.6f}; exact-enum S2(l={l}) = {exact:.4f}", flush=True)

    neel = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
    ests = []
    for k in range(nseed):
        seed = 1000 + 77 * k
        sa = AmplitudeSampler(machine, params, n_walkers=2048, key=seed + 17, n_beta=4, device=dev)
        sb = AmplitudeSampler(machine, params, n_walkers=2048, key=seed + 987654341, n_beta=4, device=dev)
        base, base_err = swap_base_z2(sa, sb, 1, niter, 2, nwarm)
        glue, glue_err, _ = renyi2_increment(machine, params, l, niter, 2, nwarm, walkers_per_level=n_glue, key=seed,
                                             level_offset=1, init_spins=(neel, neel), device=dev)
        tot, err = base + glue, float(np.sqrt(base_err**2 + glue_err**2))
        ests.append((tot, err))
        print(f"# seed {k}: base {base:.4f}(±{base_err:.4f}) glue {glue:+.4f}(±{glue_err:.4f}) -> S2 = {tot:.4f} "
              f"± {err:.4f}  [pull {(tot - exact) / err:+.2f}]", flush=True)

    vals = np.array([t for t, _ in ests])
    errs = np.array([e_ for _, e_ in ests])
    mean = float(vals.mean())
    sem = float(vals.std(ddof=1) / math.sqrt(len(vals))) if len(vals) > 1 else float(errs[0])
    print(f"# mean over {nseed} seeds: S2 = {mean:.4f} ± {sem:.4f} (exact {exact:.4f}; bias {mean - exact:+.4f} "
          f"± {sem:.4f}; mean formal err {errs.mean():.4f})")
    out = {"n": n, "l": l, "theta": theta, "energy": e, "exact_s2": exact, "estimates": [list(x) for x in ests],
           "mean": mean, "sem": sem, "device": torch.cuda.get_device_name(0) if dev != "cpu" else "cpu"}
    with open(os.path.join(ns.out, "renyi_inc_calibration.json"), "w") as f:
        json.dump(out, f)
    return out


if __name__ == "__main__":
    main()
