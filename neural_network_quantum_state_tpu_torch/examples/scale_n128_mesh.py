"""Scaled sampling on the port: the N = 128 chain, RBM alpha = 4, 4096
walkers sharded over a walker mesh with the SR sums reduced across shards.

The mesh (``parallel.make_mesh``) has a shard on every visible card and at
least 4 shards: on one card 4 shards of ``cuda:0``, as ``chip_smoke.py``
phase 15d runs them. With ``--device cpu`` it is the same
sharded program on 8 CPU shards at the example's lighter sizes (K = 512,
5 warm-up sweeps, 3 steps):

    python -m neural_network_quantum_state_tpu_torch.examples.scale_n128_mesh [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np

from neural_network_quantum_state_tpu_torch.examples import common_args

N, ALPHA = 128, 4


def run(device: str = "cuda", n: int = N) -> list[dict]:
    """The sharded training run; returns its history."""
    import torch

    from neural_network_quantum_state_tpu_torch import VMC, VMCConfig, parallel
    from neural_network_quantum_state_tpu_torch.hamiltonians import LITFIChain
    from neural_network_quantum_state_tpu_torch.models import RBM

    on_cpu = device == "cpu"
    mesh = parallel.make_mesh(8, device="cpu") if on_cpu else parallel.make_mesh(max(4, torch.cuda.device_count()))
    # full production size on the cards; a lighter but identically sharded program on the CPU
    k = 512 if on_cpu else 4096
    n_warm, n_iter = (5, 3) if on_cpu else (200, 50)

    machine = RBM(n_inputs=n, n_hiddens=ALPHA * n, dtype=torch.float32)
    ham = LITFIChain(n_sites=n, h=-0.42, j=0.91, alpha=2.5, pbc=True)
    print(f"devices: {len(mesh.devices)} x {mesh.devices[0]}; K={k}")
    cfg = VMCConfig(n_walkers=k, learning_rate=1e-2, solver="cg", cg_max_iters=100 if on_cpu else 1000,
                    steps_per_host_loop=1 if on_cpu else 10, seed=0)
    vmc = VMC(machine, ham, cfg, mesh=mesh)
    params, state = vmc.init()
    print(f"n_vars = {machine.n_vars}; walker shards: {[tuple(s.shape) for s in state.cache.spins]}")
    state = vmc.warm_up(params, state, n_warm)
    params, state, hist, el = vmc.run(params, state, n_iter)
    print(f"{n_iter} sharded SR iterations in {el:.1f}s; E/site trace: {[round(h['energy'], 4) for h in hist[::3]]}")
    if not all(np.isfinite(h["energy"]) for h in hist):
        raise SystemExit("scale_n128_mesh: a non-finite energy")
    print("ok")
    return hist


def main(argv=None) -> None:
    ns, _ = common_args(sys.argv[1:] if argv is None else argv, __doc__.splitlines()[0])
    run(device=ns.device)


if __name__ == "__main__":
    main()
