"""A/B of the fused sweep + energy megakernel against the sweep kernel
followed by the energy kernel, on one CUDA device.

    python -m neural_network_quantum_state_tpu_torch.megakernel_ab [--n-beta 1 8] [--alpha 4] [--reps 50]

The shape of the JAX package's ``scripts/bench_megakernel_ab.py``:
``RBMTrSymm(64, alpha=4)`` (H=256; ``--alpha 1`` and ``8`` give H = 64 and
512), ``LITFIChain(64, h=-0.5, j=0.866, alpha=2.5, pbc=True)`` with its Neel
start, K=8192 walkers, one sweep per call (nms=1), ``reps`` chained calls
per arm; float32, random weights from ``seed``.

- Arm A (two kernels): ``ops.sweep.sweep_cuda``, then
  ``ops.energy.offdiag_sum_cuda`` on the new state.
- Arm B (megakernel): ``ops.sweep_energy.sweeps_offdiag_cuda``.

Both arms run the same pre-drawn uniform blocks (one (N, K) flip block and,
for n_beta > 1, one (1, 2, K) swap block per call), so they make the same
decisions. The cross-check runs both once from the same state on the same
draws and counts the walkers whose spins differ and the relative error of
the off-diagonal sums on the others. Each arm is timed with CUDA events
over its chain of calls, in the order A, B, B, A. Prints one JSON object
per n_beta; exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from neural_network_quantum_state_tpu_torch.hamiltonians import LITFIChain
from neural_network_quantum_state_tpu_torch.models import RBMTrSymm
from neural_network_quantum_state_tpu_torch.ops import engine
from neural_network_quantum_state_tpu_torch.ops.energy import offdiag_sum_cuda
from neural_network_quantum_state_tpu_torch.ops.rng import make_generator, uniform_block
from neural_network_quantum_state_tpu_torch.ops.sweep import sweep_cuda
from neural_network_quantum_state_tpu_torch.ops.sweep_energy import sweeps_offdiag_cuda

N, ALPHA, K = 64, 4, 8192
REPS = 50


def _chain_ms(arm, cache, blocks) -> float:
    """Mean ms per call of `arm` chained over the blocks (CUDA events)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for u, u_swap in blocks:
        cache, _ = arm(cache, u, u_swap)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / len(blocks)


def run_ab(n_beta: int, reps: int = REPS, seed: int = 0, alpha: int = ALPHA) -> dict:
    """Cross-check and time both arms at n_beta and H = alpha N; returns the
    numbers."""
    dev = torch.device("cuda")
    machine = RBMTrSymm(n_inputs=N, alpha=alpha, dtype=torch.float32)
    ham = LITFIChain(n_sites=N, h=-0.5, j=0.866, alpha=2.5, pbc=True)
    g = make_generator(seed, dev)
    work = machine.make_work(machine.init_params(g))
    cache, _ = engine.full_forward(work, ham.init_spins(g, K))
    sched = torch.as_tensor(ham.schedule(), dtype=torch.int32, device=dev)
    blocks = [(uniform_block(g, (N, K)), uniform_block(g, (1, 2, K)) if n_beta > 1 else None) for _ in range(reps)]

    def two_kernel(cache, u, u_swap):
        cache, _, _ = sweep_cuda(work, cache, sched, u, n_beta, u_swap)
        return cache, offdiag_sum_cuda(work, cache)

    def megakernel(cache, u, u_swap):
        cache, _, _, off = sweeps_offdiag_cuda(work, cache, sched, u, n_beta, u_swap)
        return cache, off

    ca, oa = two_kernel(cache, *blocks[0])
    cb, ob = megakernel(cache, *blocks[0])
    same = (ca.spins == cb.spins).all(1)
    off_err = float((oa[same] - ob[same]).abs().max() / oa[same].abs().max())
    y_err = float((ca.y[same] - cb.y[same]).abs().max())
    times = {"two_kernel": [], "megakernel": []}
    for name in ("two_kernel", "megakernel", "megakernel", "two_kernel"):
        arm = two_kernel if name == "two_kernel" else megakernel
        times[name].append(_chain_ms(arm, cache, blocks))
    two_ms, mega_ms = (sum(v) / len(v) for v in times.values())
    return {
        "n_beta": n_beta, "N": N, "H": machine.n_hidden, "K": K, "reps": reps,
        "two_kernel_ms": two_ms, "megakernel_ms": mega_ms, "speedup": two_ms / mega_ms,
        "two_kernel_runs_ms": times["two_kernel"], "megakernel_runs_ms": times["megakernel"],
        "mismatch_share": 1.0 - float(same.double().mean()), "offdiag_rel_err": off_err, "y_max_abs_err": y_err,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n-beta", type=int, nargs="+", default=[1, 8])
    parser.add_argument("--alpha", type=int, default=ALPHA, help="hidden units per site: H = alpha * 64")
    parser.add_argument("--reps", type=int, default=REPS)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("megakernel_ab: needs a CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    print(f"device: {torch.cuda.get_device_name(0)}")
    for n_beta in args.n_beta:
        print(json.dumps(run_ab(n_beta, args.reps, args.seed, args.alpha)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
