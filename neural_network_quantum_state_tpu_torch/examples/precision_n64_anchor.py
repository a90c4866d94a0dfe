"""N = 64 LR-AFM precision anchor on the port: mixed precision against
float64 end to end.

The reference trains in double end to end; there is no exact
diagonalization at N = 64, so the anchor is a float64 SR run and the claim
is that the mixed-precision mode (float32 sampling and local energies, the
float64 SR solve: ``VMCConfig.solve_dtype``) reproduces it to 1e-4
relative energy. Both arms start from the flagship checkpoint
``runs/RBMTrSymmLICH-L64NF4A2.5T2V1`` (read only), take 500 warm-up sweeps
and ``niter`` SR steps, and report the mean of the last ``ntail``. On the
card both arms run there: the float64 arm through the sweep's and energy
kernel's float64 instances, the mixed arm through the float32 ones.

    python -m neural_network_quantum_state_tpu_torch.examples.precision_n64_anchor both  [niter] [ntail]
    python -m neural_network_quantum_state_tpu_torch.examples.precision_n64_anchor f64   [niter] [ntail]
    python -m neural_network_quantum_state_tpu_torch.examples.precision_n64_anchor mixed [niter] [ntail]
    python -m neural_network_quantum_state_tpu_torch.examples.precision_n64_anchor report

``f64`` and ``mixed`` write ``anchor_{arm}.json`` into ``--out``; ``report``
combines the two files, ``both`` runs the arms in turn and writes all three.
"""

from __future__ import annotations

import json
import math
import os
import sys

import numpy as np

from neural_network_quantum_state_tpu_torch.examples import REPO, common_args

CKPT = os.path.join(REPO, "runs", "RBMTrSymmLICH-L64NF4A2.5T2V1")
N, ALPHA, THETA, ALPHA_J, N_WALKERS, WARM_SWEEPS = 64, 4, 2.0, 2.5, 4096, 500


def run(mode: str, niter: int, ntail: int, out: str, device: str = "cuda", n_walkers: int = N_WALKERS,
        warm_sweeps: int = WARM_SWEEPS, ckpt: str = CKPT, n: int = N) -> dict:
    """One arm from the checkpoint (of RBMTrSymm(n, alpha 4)); writes and
    returns its record."""
    import torch

    from neural_network_quantum_state_tpu_torch import VMC, VMCConfig
    from neural_network_quantum_state_tpu_torch.hamiltonians import LITFIChain
    from neural_network_quantum_state_tpu_torch.models import RBMTrSymm
    from neural_network_quantum_state_tpu_torch.utils.checkpoint import load_reference_text

    if mode == "f64":
        machine = RBMTrSymm(n_inputs=n, alpha=ALPHA, dtype=torch.float64)
        cfg = VMCConfig(n_walkers=n_walkers, learning_rate=1e-2, solver="cg", steps_per_host_loop=25, seed=11)
    elif mode == "mixed":  # float32 machine and sampling, float64 estimators and solve
        machine = RBMTrSymm(n_inputs=n, alpha=ALPHA, dtype=torch.float32)
        cfg = VMCConfig(n_walkers=n_walkers, learning_rate=1e-2, solver="cg", solve_dtype=torch.float64,
                        steps_per_host_loop=25, use_fused_sweeps=device != "cpu", seed=12)
    else:
        raise ValueError(f"precision_n64_anchor: unknown arm {mode!r} (f64, mixed)")
    ham = LITFIChain(n_sites=n, h=-math.cos(THETA), j=math.sin(THETA), alpha=ALPHA_J, pbc=True)
    vmc = VMC(machine, ham, cfg, device=device)
    _, state = vmc.init()
    params = load_reference_text(machine, ckpt, device=device)
    state = vmc.warm_up(params, state, warm_sweeps)
    params, state, history, elapsed = vmc.run(params, state, niter)
    tail = [hh["energy"] for hh in history[-ntail:]]
    rec = {"arm": mode, "energy": float(np.mean(tail)), "sem": float(np.std(tail) / np.sqrt(len(tail))),
           "niter": niter, "ntail": ntail, "seconds": elapsed, "step_ms": elapsed / max(len(history), 1) * 1e3,
           "device": torch.cuda.get_device_name(0) if device != "cpu" else "cpu"}
    print(f"# {mode}: E/site = {rec['energy']:+.6f} +/- {rec['sem']:.2e}  ({elapsed:.0f}s, "
          f"{rec['step_ms']:.1f} ms/iter)", flush=True)
    with open(os.path.join(out, f"anchor_{mode}.json"), "w") as f:
        json.dump(rec, f)
    return rec


def report(out: str) -> dict:
    """The mixed arm's relative difference from the float64 arm, from the
    two files in ``out``; written to ``anchor_report.json``."""
    with open(os.path.join(out, "anchor_f64.json")) as f:
        e64 = json.load(f)["energy"]
    with open(os.path.join(out, "anchor_mixed.json")) as f:
        emix = json.load(f)["energy"]
    rec = {"metric": "N64_LICH_energy_mixed_vs_f64_anchor_rel_err", "anchor_f64": e64, "mixed": emix,
           "value": abs(emix - e64) / abs(e64), "unit": "rel_err"}
    with open(os.path.join(out, "anchor_report.json"), "w") as f:
        json.dump(rec, f)
    print(json.dumps(rec))
    return rec


def main(argv=None) -> None:
    ns, rest = common_args(sys.argv[1:] if argv is None else argv, __doc__.splitlines()[0])
    arm = rest[0] if rest else "both"
    niter = int(rest[1]) if len(rest) > 1 else 2000
    ntail = int(rest[2]) if len(rest) > 2 else 500
    if arm != "report":
        for mode in ("f64", "mixed") if arm == "both" else (arm,):
            run(mode, niter, ntail, ns.out, device=ns.device)
    if arm in ("both", "report"):
        report(ns.out)


if __name__ == "__main__":
    main()
