"""Flagship run on the port: the N = 64 long-range AFM Ising chain ground
state (the paper's configuration).

The reference's LICH-train_rbmtrsymm.cu workflow (J = sin theta,
h = -cos theta, J_ij = J/d^alpha, PBC, RBMTrSymm(64, alpha 4), K = 8192) on
one card: every sampler call one launch of the sweep kernel, every step one
of the energy kernel, 50 steps a host loop. Writes a reference-format
checkpoint (every 1000 steps and at the end) and a metrics JSONL into
``--out``, then measures the staggered magnetization's moments and Binder
cumulant of the trained state.

    python -m neural_network_quantum_state_tpu_torch.examples.train_lich64 [theta] [alpha] [niter]
"""

from __future__ import annotations

import math
import os
import sys
import time

import numpy as np

from neural_network_quantum_state_tpu_torch.examples import common_args

N, NF, K = 64, 4, 8192


def train(theta: float, alpha_j: float, niter: int, out: str, device: str = "cuda", n: int = N, n_walkers: int = K,
          warm_sweeps: int = 500, meas=(4096, 50, 300)) -> dict:
    """Train, save and measure; ``meas`` the (walkers, iterations, warm-up
    sweeps) of the magnetization run. Returns the energy, the moments and
    the checkpoint's prefix."""
    import torch

    from neural_network_quantum_state_tpu_torch import VMC, VMCConfig
    from neural_network_quantum_state_tpu_torch.hamiltonians import LITFIChain
    from neural_network_quantum_state_tpu_torch.measurements import AmplitudeSampler, order_parameter
    from neural_network_quantum_state_tpu_torch.models import RBMTrSymm
    from neural_network_quantum_state_tpu_torch.utils.checkpoint import save_reference_text
    from neural_network_quantum_state_tpu_torch.utils.metrics import MetricsLogger

    machine = RBMTrSymm(n_inputs=n, alpha=NF, dtype=torch.float32)
    ham = LITFIChain(n_sites=n, h=-math.cos(theta), j=math.sin(theta), alpha=alpha_j, pbc=True)
    cfg = VMCConfig(n_walkers=n_walkers, learning_rate=1e-2, solver="cg", rsd_cutoff=1e-3, steps_per_host_loop=50,
                    use_fused_sweeps=device != "cpu", seed=7)
    vmc = VMC(machine, ham, cfg, device=device)
    params, state = vmc.init()
    t0 = time.time()
    state = vmc.warm_up(params, state, warm_sweeps)

    prefix = os.path.join(out, f"RBMTrSymmLICH-L{n}NF{NF}A{alpha_j:g}T{theta:g}V1")
    log = MetricsLogger(prefix + ".metrics.jsonl", echo=False)

    def cb(step, stats):
        log.log(step, energy=float(stats.energy.real), rsd=float(stats.rsd), cg=int(stats.cg_iters))
        if step % 1000 == 999:
            print(f"iter {step + 1}: E/site = {float(stats.energy.real):+.6f}  rsd = {float(stats.rsd):.3e}", flush=True)

    def ckpt(step, cur_params, cur_state):
        save_reference_text(machine, cur_params, prefix)

    try:
        params, state, hist, _ = vmc.run(params, state, niter, callback=cb, checkpoint_fn=ckpt, checkpoint_every=1000)
    finally:
        log.close()
    save_reference_text(machine, params, prefix)
    e = float(np.mean([x["energy"] for x in hist[-500:]]))
    print(f"converged E/site = {e:.6f} after {len(hist)} iters in {time.time() - t0:.0f}s", flush=True)

    n_meas, n_iter, n_warm = meas
    smp = AmplitudeSampler(machine, params, n_meas, key=99, device=device)
    stag = torch.as_tensor((-1.0) ** np.arange(n), dtype=torch.float32, device=device)
    m1, m2, m4 = order_parameter(smp, stag, n_iterations=n_iter, n_sweeps=2, n_warmup=n_warm)
    binder = 1 - m4 / (3 * m2 * m2)
    print(f"staggered magnetization: m1={m1:.4f} m2={m2:.4f} m4={m4:.4f} binder={binder:.4f}")
    return {"energy": e, "steps": len(hist), "m1": m1, "m2": m2, "m4": m4, "binder": binder, "prefix": prefix}


def main(argv=None) -> None:
    ns, rest = common_args(sys.argv[1:] if argv is None else argv, __doc__.splitlines()[0])
    theta = float(rest[0]) if len(rest) > 0 else 2.0
    alpha_j = float(rest[1]) if len(rest) > 1 else 2.5
    niter = int(rest[2]) if len(rest) > 2 else 20000
    train(theta, alpha_j, niter, ns.out, device=ns.device)


if __name__ == "__main__":
    main()
