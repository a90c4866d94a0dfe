#!/usr/bin/env python3
"""The one-device SR step time of the port's flagship paths, on one NVIDIA GPU.

    python3 scripts/step_time.py [--tree DIR] [--label NAME] [--paths NAME,..] [--mesh N]

Drives ``chip_smoke.py``'s phases 4-7 through ``VMC``: the same models, sizes,
seeds and depths (the LITFI flagship ``RBMTrSymm(64, alpha=4)`` on
``LITFIChain(64)``, K=8192, CG, 100 warm-up sweeps + 20 steps; the Hubbard
flagship ``RBM(64, 64)`` on the L=32 trap, K=4096, 500 + 20; the LITFI
flagship tempered at n_beta=4; ``FFNNTrSymm(64, alpha=4)`` on the LITFI
chain), and the Hubbard flagship in float64 (the float64 exchange
instances; 100 + 20, as phase 15b's float64 trap warms up). The step time is the host clock between ``VMC.run``'s callbacks,
synchronised at the end, the mean after the first step, as ``chip_smoke.py``
prints it. ``--paths`` keeps the named paths only (``LITFI``, ``Hubbard``,
``tempered LITFI``, ``FFNN LITFI``, ``float64 Hubbard``; all by default). ``--mesh N`` also times
the LITFI flagship on ``make_mesh(N)``, N shards round-robin over the
visible cards (where the tree has ``parallel/``).

``--tree DIR`` imports the package from DIR instead of this checkout (for
example the parent commit unpacked with ``git archive`` into a gitignored
directory), so that two versions run in one call on one card: run parent,
change, change, parent. Each tree builds its kernels once into its own
gitignored ``build/`` directory, all sources at once. The last line of the
output is one JSON object: the label, the card's name and power limit, and
the step ms of every path.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

N, ALPHA, K = 64, 4, 8192
HUB_L, HUB_H, HUB_K, HUB_PARTICLES, HUB_TRAP = 32, 64, 4096, 5, 0.05
WARM, STEPS, HUB_WARM = 100, 20, 500


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="change")
    ap.add_argument("--paths", default="")
    ap.add_argument("--mesh", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("step_time: no CUDA device", file=sys.stderr)
        return 1
    from neural_network_quantum_state_tpu_torch import VMC, VMCConfig
    from neural_network_quantum_state_tpu_torch.hamiltonians import HubbardChain, LITFIChain
    from neural_network_quantum_state_tpu_torch.models import RBM, FFNNTrSymm, RBMTrSymm
    from neural_network_quantum_state_tpu_torch.ops import build

    import neural_network_quantum_state_tpu_torch as pkg

    print(f"{args.label}: package from {Path(pkg.__file__).parent}")
    t0 = time.perf_counter()
    build.build([name for name in ("sweep", "energy", "exchange", "exchange_tempered", "exchange_f64")
                 if name in build.KERNELS])
    print(f"{args.label}: kernels built or found in {time.perf_counter() - t0:.1f} s")

    litfi = LITFIChain(n_sites=N, h=-0.5, j=0.866, alpha=2.5, pbc=True)
    hub_v = tuple(float(x) for x in [HUB_TRAP * (i - (HUB_L - 1) / 2.0) ** 2 for i in range(HUB_L)] * 2)
    hubbard = HubbardChain(n_sites=2 * HUB_L, u=4.0, t=1.0, n_up=HUB_PARTICLES, n_down=HUB_PARTICLES, pbc=True,
                           v=hub_v)

    def cfg(k, seed, fused=True, **kw):  # a float64 machine samples with use_fused_sweeps off, as the train driver
        return VMCConfig(n_walkers=k, learning_rate=1e-2, solver="cg", use_fused_sweeps=fused, seed=seed, **kw)

    paths = {
        "LITFI": (lambda **m: VMC(RBMTrSymm(n_inputs=N, alpha=ALPHA, dtype=torch.float32), litfi, cfg(K, 3), **m),
                  WARM),
        "Hubbard": (lambda **m: VMC(RBM(n_inputs=2 * HUB_L, n_hiddens=HUB_H, dtype=torch.float32), hubbard,
                                    cfg(HUB_K, 11), **m), HUB_WARM),
        "tempered LITFI": (lambda **m: VMC(RBMTrSymm(n_inputs=N, alpha=ALPHA, dtype=torch.float32), litfi,
                                           cfg(K, 5, n_beta=4), **m), WARM),
        "FFNN LITFI": (lambda **m: VMC(FFNNTrSymm(n_inputs=N, alpha=ALPHA, dtype=torch.float32), litfi, cfg(K, 3),
                                       **m), WARM),
        "float64 Hubbard": (lambda **m: VMC(RBM(n_inputs=2 * HUB_L, n_hiddens=HUB_H, dtype=torch.float64), hubbard,
                                            cfg(HUB_K, 11, fused=False), **m), WARM),
    }
    keep = args.paths.split(",") if args.paths else list(paths)
    runs = [(name, make, warm, {}) for name, (make, warm) in paths.items() if name in keep]
    if args.mesh:
        from neural_network_quantum_state_tpu_torch.parallel import make_mesh

        runs.append((f"LITFI make_mesh({args.mesh})", paths["LITFI"][0], WARM, {"mesh": make_mesh(args.mesh)}))

    out = {}
    for name, make, warm, kw in runs:
        vmc = make(**kw)
        params, state = vmc.init()
        state = vmc.warm_up(params, state, warm)
        torch.cuda.synchronize()
        stamps = [time.perf_counter()]
        _, _, history, _ = vmc.run(params, state, STEPS, callback=lambda i, st: stamps.append(time.perf_counter()))
        torch.cuda.synchronize()
        steps_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
        mean = sum(steps_ms[1:]) / (len(steps_ms) - 1)
        print(f"{args.label} {name}: step ms first {steps_ms[0]:.3f}, mean of the rest {mean:.3f}; "
              f"last energy {history[-1]['energy']}")
        out[name] = mean
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"label": args.label, "card": card, "step_ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
