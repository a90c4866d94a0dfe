"""Renyi-2 cat-state study on the port: why trained deep-ordered states show
S2 < ln 2.

Trained N = 64 states at theta = 1.57 measured a half-chain Renyi-2 entropy
of ~0.59 < ln 2, below the floor of the symmetric two-Neel cat state. The
hypothesis: the trained RBMTrSymm carries unequal weight on the two Neel
sectors (nothing in the energy tells them apart at h ~ 0, so training
freezes whatever asymmetry the start and the sampling noise made), while a
spin-flip-symmetric ansatz (RBMSfSymm, no biases) has psi(s) = psi(-s) and
so the full ln 2 by construction. This study settles it at an ED-checkable
size (default N = 12, l = 6, float64, exact enumeration of the ansatz over
its 2^N states: no estimator noise):

  1. the ED ground state of LITFIChain(theta, alpha_J): exact S2 and Neel
     sector weights (w+ = P(m_s > 0) etc.);
  2. RBMTrSymm trained (tempered, with block moves, as the chip campaigns):
     exact-enumeration S2, sector weights, energy error;
  3. RBMTrSymm with the round-2 protocol (single flips, untempered), and
     RBMSfSymm (tempered): the same;
  4. the two-replica swap estimator, the increment estimator and the hybrid
     (Z2-quadrature swap base at l0 = 1 and a Neel-start glued chain)
     against the exact-enumeration S2 of the trained RBMTrSymm.

On the card the training and the estimators' sampling run through the
sweep kernel's float64 instances and the energy kernel's float64 instance;
the ED and the enumeration on the host.

    python -m neural_network_quantum_state_tpu_torch.examples.renyi_cat_study [-L=12] [-theta=1.57] [--device cpu]

Writes its table as ``renyi_cat_study.json`` into ``--out``.
"""

from __future__ import annotations

import json
import math
import os
import sys

import numpy as np

from neural_network_quantum_state_tpu_torch.examples import common_args


def all_spins(n: int) -> np.ndarray:
    idx = np.arange(2**n)
    bits = (idx[:, None] >> np.arange(n)[None, :]) & 1
    return 1.0 - 2.0 * bits  # basis-index bit i = site i, +1 for bit 0


def psi_of(machine, params) -> np.ndarray:
    """Normalized wavefunction over the full 2^N basis (exact enumeration)."""
    import torch

    from neural_network_quantum_state_tpu_torch.ops import engine

    device = next(iter(params.values())).device
    s = torch.as_tensor(all_spins(machine.n_inputs), dtype=torch.float64, device=device)
    work = machine.make_work({k: v.to(torch.complex128) for k, v in params.items()})
    ln = engine.log_psi(work, s).cpu().numpy()
    psi = np.exp(ln - ln.real.max())  # stabilize before normalizing
    return psi / np.linalg.norm(psi)


def s2_exact(psi: np.ndarray, n: int, l: int) -> float:
    """Exact half-block Renyi-2: A = sites [0, l) = low l index bits."""
    m = psi.reshape(2 ** (n - l), 2**l)  # [b, a], B-major
    rho_a = m.T @ m.conj()
    return float(-np.log(np.real(np.trace(rho_a @ rho_a))))


def sector_weights(psi: np.ndarray, n: int) -> tuple[float, float, float]:
    """Probability weight on m_s > 0 / < 0 / = 0 (staggered sectors)."""
    s = all_spins(n)
    stag = (s * np.where(np.arange(n) % 2 == 0, 1.0, -1.0)).sum(axis=1)
    p = np.abs(psi) ** 2
    return float(p[stag > 0].sum()), float(p[stag < 0].sum()), float(p[stag == 0].sum())


def train(machine, ham, seed: int, n_iter: int, n_walkers: int, tempered: bool = True, device: str = "cuda",
          warm_sweeps: int = 300):
    """SR training with the campaign's methodology (tempered sampling and
    block flips: theta = 1.57 single flips freeze); tempered=False is the
    round-2 protocol under which the N = 64 S2 < ln 2 was measured. Returns
    (params, the mean energy of the last 25 steps)."""
    from neural_network_quantum_state_tpu_torch import VMC, VMCConfig

    cfg = VMCConfig(n_walkers=n_walkers, learning_rate=1e-2, solver="cg", seed=seed, n_beta=4 if tempered else 1,
                    block_moves_per_sweep=1 if tempered else 0, steps_per_host_loop=25)
    vmc = VMC(machine, ham, cfg, device=device)
    params, state = vmc.init()
    state = vmc.warm_up(params, state, warm_sweeps)
    params, state, history, _ = vmc.run(params, state, n_iter)
    return params, float(np.mean([h["energy"] for h in history[-25:]]))


def main(argv=None) -> dict:
    import torch

    from neural_network_quantum_state_tpu_torch.hamiltonians import LITFIChain
    from neural_network_quantum_state_tpu_torch.measurements import AmplitudeSampler, renyi2_entropy, renyi2_increment
    from neural_network_quantum_state_tpu_torch.measurements.renyi_increment import swap_base_z2
    from neural_network_quantum_state_tpu_torch.models import RBMSfSymm, RBMTrSymm
    from neural_network_quantum_state_tpu_torch.utils.cli import DriverArgs
    from neural_network_quantum_state_tpu_torch.utils.exact import ground_state, litfi_chain_dense

    ns, rest = common_args(sys.argv[1:] if argv is None else argv, __doc__.splitlines()[0])
    args = DriverArgs(
        rest,
        options=[
            ("L", "chain length (ED-reachable; default 12)"),
            ("theta", "J = sin(theta), h = -cos(theta)"),
            ("alpha", "long-range decay exponent alpha_J"),
            ("nf", "RBM filters (alpha) per ansatz"),
            ("niter", "SR iterations per arm"),
            ("ns", "walkers"),
            ("seed", "RNG seed"),
            ("nmeas", "estimator iterations of the cross-checks"),
        ],
        defaults={"L": "12", "theta": "1.57", "alpha": "2.5", "nf": "4", "niter": "1500", "ns": "1024", "seed": "1",
                  "nmeas": "60"},
        prog="renyi_cat_study",
    )
    dev = ns.device
    n = args.find("L", int)
    l = n // 2
    theta, alpha_j, nf = args.find("theta", float), args.find("alpha", float), args.find("nf", int)
    n_iter, n_walkers, seed = args.find("niter", int), args.find("ns", int), args.find("seed", int)
    n_meas = args.find("nmeas", int)
    j, h = math.sin(theta), -math.cos(theta)

    # 1. the ED oracle
    e0, psi0 = ground_state(litfi_chain_dense(n, h=h, j=j, alpha=alpha_j, pbc=True))
    psi0 = psi0 / np.linalg.norm(psi0)
    rows = [("exact (ED)", s2_exact(psi0, n, l), sector_weights(psi0, n), 0.0)]
    print(f"# LITFI N={n} theta={theta} alpha_J={alpha_j}: E0/site = {e0:.6f}, "
          f"exact S2(l={l}) = {rows[0][1]:.4f}  (ln 2 = {math.log(2):.4f})", flush=True)

    ham = LITFIChain(n_sites=n, h=h, j=j, alpha=alpha_j, pbc=True)
    arms = [
        ("RBMTrSymm", RBMTrSymm(n_inputs=n, alpha=nf, dtype=torch.float64), True),
        # the round-2 protocol (single flips, untempered): the arm that should
        # reproduce the sector-weight asymmetry behind S2 < ln 2 at N = 64
        ("TrSymm-noPT", RBMTrSymm(n_inputs=n, alpha=nf, dtype=torch.float64), False),
        ("RBMSfSymm", RBMSfSymm(n_inputs=n, alpha=nf, dtype=torch.float64), True),
    ]
    trained = {}
    for name, machine, tempered in arms:
        params, e = train(machine, ham, seed, n_iter, n_walkers, tempered, device=dev)
        psi = psi_of(machine, params)
        rel = abs(e - e0) / abs(e0)
        rows.append((name, s2_exact(psi, n, l), sector_weights(psi, n), rel))
        trained[name] = (machine, params)
        print(f"# trained {name}: E/site = {e:.6f} (rel err {rel:.1e})", flush=True)

    print(f"\n{'state':<14} {'S2':>8} {'w(+)':>8} {'w(-)':>8} {'w(0)':>8} {'asym':>8} {'E relerr':>9}")
    table = []
    for name, s2, (wp, wm, w0), rel in rows:
        asym = abs(wp - wm) / max(wp + wm, 1e-300)
        table.append({"state": name, "s2": s2, "w_plus": wp, "w_minus": wm, "w_zero": w0, "asym": asym,
                      "e_rel_err": rel})
        print(f"{name:<14} {s2:8.4f} {wp:8.4f} {wm:8.4f} {w0:8.4f} {asym:8.4f} {rel:9.1e}")

    # 4. the estimators against the exact-enumeration S2 of the symmetry-broken arm
    machine, params = trained["RBMTrSymm"]
    exact = next(r[1] for r in rows if r[0] == "RBMTrSymm")
    s1 = AmplitudeSampler(machine, params, n_walkers=2048, key=seed + 100, device=dev)
    s2_ = AmplitudeSampler(machine, params, n_walkers=2048, key=seed + 200, device=dev)
    est = renyi2_entropy(s1, s2_, l, n_iterations=n_meas, n_sweeps=2, n_warmup=200)
    print(f"\n# swap-estimator cross-check (RBMTrSymm): {est:.4f} vs exact-enum {exact:.4f}  "
          f"(|diff| = {abs(est - exact):.4f})")
    # the increment trick at a comparable budget: its glued-ensemble ratio is O(1) per level
    inc, inc_err, _ = renyi2_increment(machine, params, l, n_iterations=n_meas, n_sweeps=2, n_warmup=200,
                                       walkers_per_level=512, key=seed + 300, device=dev)
    print(f"# increment-estimator cross-check (RBMTrSymm): {inc:.4f} +/- {inc_err:.4f} vs exact-enum {exact:.4f}  "
          f"(|diff| = {abs(inc - exact):.4f})")
    # the hybrid: a Z2-orbit-quadrature swap base at l0 = 1 and a Neel-start glued chain for levels 1..l-1
    sa = AmplitudeSampler(machine, params, n_walkers=2048, key=seed + 400, device=dev)
    sb = AmplitudeSampler(machine, params, n_walkers=2048, key=seed + 500, device=dev)
    base, base_err = swap_base_z2(sa, sb, 1, n_iterations=n_meas, n_sweeps=2, n_warmup=200)
    neel = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
    inc2, inc2_err, _ = renyi2_increment(machine, params, l, n_iterations=n_meas, n_sweeps=2, n_warmup=200,
                                         walkers_per_level=512, key=seed + 600, level_offset=1,
                                         init_spins=(neel, neel), device=dev)
    tot, tot_err = base + inc2, float(np.sqrt(base_err**2 + inc2_err**2))
    print(f"# hybrid (z2 base {base:.4f} + glue {inc2:+.4f}) cross-check: {tot:.4f} +/- {tot_err:.4f} "
          f"vs exact-enum {exact:.4f}  (|diff| = {abs(tot - exact):.4f})")
    out = {"n": n, "l": l, "theta": theta, "alpha_j": alpha_j, "e0": e0, "table": table, "exact_s2": exact,
           "swap": est, "increment": [inc, inc_err], "hybrid": [tot, tot_err], "device":
           torch.cuda.get_device_name(0) if dev != "cpu" else "cpu"}
    with open(os.path.join(ns.out, "renyi_cat_study.json"), "w") as f:
        json.dump(out, f)
    return out


if __name__ == "__main__":
    main()
