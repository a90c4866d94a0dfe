"""The port's benchmark: the JAX package's five metrics (bench.py) on the card.

    python -m neural_network_quantum_state_tpu_torch.bench [--device cuda|cpu]

prints one JSON line per metric, in bench.py's order, with its metric
names, shapes, seeds and step counts, run through the port's entry points:

1. the N=16 TFI ground-state energy's relative error against the exact
   Jordan-Wigner value, trained with float32 sampling and a float64 SR
   solve (K=4096, 300 warm-up sweeps, 1500 steps, mean of the last 300);
2. SR solves per second on the LITFI flagship (RBMTrSymm N=64, alpha=4,
   K=8192: 100 warm-up sweeps, a 50-step settle, 200 timed steps);
3. the energy kernel's ms per call at N=64, H=256, K=8192 (20 calls);
4. Kawasaki exchange walker-sweeps per second on the L=32 Hubbard chain with
   RBM(64, 64), K=4096 (5 calls of 5 sweeps, one launch each);
5. Metropolis walker-sweeps per second at the flagship shape (5 calls of 20
   sweeps, one launch each), last, as bench.py prints its headline.

Times are host-clock spans closed by ``torch.cuda.synchronize()``.
``gflops_analytic`` keeps bench.py's operation-count convention (41 N H per
walker-sweep, 47 N H per local-energy estimate). The percentages name the
card, not a TPU: ``pct_h100_f32_peak`` is the share of the H100's 67 TFLOP/s
float32 peak (the line carries the card's name and power limit, as
nvidia-smi reports them), ``pct_hot_math_probe`` the share of the elements
per second the card sustains on the kernel's hot math alone
(``ops/chain_rate.py``, the port of bench.py's probe): above 100 means the
probe is not an upper bound. ``vs_baseline`` keeps the 1e-4 precision bar
of the error metric; the other lines have none (bench.py's 20k sweeps/s
target was set for a TPU).

Every line names the device it ran on. With ``--device cpu`` the metrics
run on the plain versions (slowly at these sizes; each metric function
takes its sizes as keyword arguments, so that the tests call it small), and
the device shares are null: a CPU time is not a card's.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from neural_network_quantum_state_tpu_torch.hamiltonians import HubbardChain, LITFIChain, TFIChain
from neural_network_quantum_state_tpu_torch.models import RBM, RBMTrSymm
from neural_network_quantum_state_tpu_torch.ops import energy
from neural_network_quantum_state_tpu_torch.ops.chain_rate import chain_rate
from neural_network_quantum_state_tpu_torch.ops.rng import make_generator
from neural_network_quantum_state_tpu_torch.sampler import init_state, kawasaki, metropolis
from neural_network_quantum_state_tpu_torch.utils.exact import tfi_chain_exact_energy
from neural_network_quantum_state_tpu_torch.vmc import VMC, VMCConfig

BASELINE_REL_ERR = 1e-4  # bench.py's precision bar (BASELINE.json)
H100_F32_PEAK = 67e12  # float32 outside the tensor cores (H100 SXM data sheet, 700 W)

_PROBE_RATES: dict = {}


def _sweep_flops(n_sites: int, h: int) -> float:
    return 41.0 * n_sites * h  # per walker-sweep (N site proposals), bench.py's convention


def _energy_flops(n_sites: int, h: int) -> float:
    return 47.0 * n_sites * h  # per walker local-energy estimate, bench.py's convention


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def probe_rates(device: torch.device) -> dict:
    """The hot-math probe's elements/s for the sweep and energy bodies (once
    per process); empty off the card."""
    if device.type == "cuda" and not _PROBE_RATES:
        _PROBE_RATES.update({body: chain_rate(body, device=device) for body in ("sweep", "energy")})
    return _PROBE_RATES if device.type == "cuda" else {}


def _shares(device: torch.device, flops_per_s: float, elems_per_s: float, body: str) -> dict:
    """The device shares of a rate line: null off the card."""
    if device.type != "cuda":
        return {"pct_h100_f32_peak": None, "pct_hot_math_probe": None, "card": None}
    return {"pct_h100_f32_peak": round(100.0 * flops_per_s / H100_F32_PEAK, 3),
            "pct_hot_math_probe": round(100.0 * elems_per_s / probe_rates(device)[body], 1), "card": _card()}


def _emit(line: dict) -> dict:
    print(json.dumps(line), flush=True)
    return line


def bench_energy_rel_err(device="cuda", n: int = 16, alpha: int = 4, n_walkers: int = 4096, warm_sweeps: int = 300,
                         steps: int = 1500, tail: int = 300) -> dict:
    """Train the N=16 TFI chain (float32 machine, float64 SR solve) and report
    the relative energy error against the exact value."""
    device = torch.device(device)
    cfg = VMCConfig(n_walkers=n_walkers, learning_rate=2e-2, solver="cg", solve_dtype=torch.float64,
                    steps_per_host_loop=50, use_fused_sweeps=device.type != "cpu", seed=7)
    vmc = VMC(RBMTrSymm(n_inputs=n, alpha=alpha, dtype=torch.float32), TFIChain(n_sites=n, h=-1.0, j=-1.0), cfg,
              device=device)
    params, state = vmc.init()
    state = vmc.warm_up(params, state, warm_sweeps)
    params, state, history, _ = vmc.run(params, state, steps)
    e = sum(h["energy"] for h in history[-tail:]) / len(history[-tail:])
    e_exact = tfi_chain_exact_energy(n, h=-1.0, j=-1.0)
    rel = abs(e - e_exact) / abs(e_exact)
    return _emit({"metric": "energy_rel_err_vs_exact_N16_TFI_mixed_precision", "value": float(f"{rel:.3g}"),
                  "unit": "rel_err", "vs_baseline": round(BASELINE_REL_ERR / max(rel, 1e-300), 3),
                  "device": _device_name(device)})


def _litfi(n: int) -> LITFIChain:
    return LITFIChain(n_sites=n, h=-0.5, j=0.866, alpha=2.5, pbc=True)


def bench_sr_solves(device="cuda", n: int = 64, alpha: int = 4, n_walkers: int = 8192, warm_sweeps: int = 100,
                    settle: int = 50, steps: int = 200) -> dict:
    """Full SR iterations per second on the LITFI flagship."""
    device = torch.device(device)
    cfg = VMCConfig(n_walkers=n_walkers, learning_rate=1e-2, solver="cg", steps_per_host_loop=settle,
                    use_fused_sweeps=device.type != "cpu", seed=3)
    vmc = VMC(RBMTrSymm(n_inputs=n, alpha=alpha, dtype=torch.float32), _litfi(n), cfg, device=device)
    params, state = vmc.init()
    state = vmc.warm_up(params, state, warm_sweeps)
    params, state, _, _ = vmc.run(params, state, settle)
    _sync(device)
    t0 = time.perf_counter()
    params, state, _, _ = vmc.run(params, state, steps)
    _sync(device)
    dt = time.perf_counter() - t0
    return _emit({"metric": "sr_solves_per_sec_N64_RBMTrSymm_a4_8192walkers", "value": round(steps / dt, 1),
                  "unit": "iters/s", "vs_baseline": None, "device": _device_name(device)})


def _flagship_state(device: torch.device, n: int, alpha: int, n_walkers: int):
    """bench.py's set-up: the flagship's init parameters (seed 0), its initial
    spins (seed 1) and a sampler state (seed 2)."""
    machine = RBMTrSymm(n_inputs=n, alpha=alpha, dtype=torch.float32)
    ham = _litfi(n)
    work = machine.make_work(machine.init_params(make_generator(0, device)))
    spins = ham.init_spins(make_generator(1, device), n_walkers, torch.float32)
    return machine, ham, work, init_state(work, spins, make_generator(2, device))


def bench_energy_kernel(device="cuda", n: int = 64, alpha: int = 4, n_walkers: int = 8192, reps: int = 20) -> dict:
    """The local-energy kernel's latency and analytic FLOP/s at the flagship
    shape: the off-diagonal sum over all N sites, the per-estimate hot loop."""
    device = torch.device(device)
    machine, _, work, state = _flagship_state(device, n, alpha, n_walkers)
    h = machine.n_hidden
    energy.offdiag_sum(work, state.cache, state.lnpsi)  # warm (and build)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        energy.offdiag_sum(work, state.cache, state.lnpsi)
    _sync(device)
    dt = time.perf_counter() - t0
    flops = n_walkers * reps * _energy_flops(n, h) / dt
    return _emit({"metric": "fused_local_energy_kernel_ms_N64_RBMTrSymm_a4_8192walkers",
                  "value": round(1e3 * dt / reps, 3), "unit": "ms/call", "vs_baseline": None,
                  "gflops_analytic": round(flops / 1e9, 1),
                  **_shares(device, flops, n_walkers * n * h * reps / dt, "energy"), "device": _device_name(device)})


def bench_exchange_throughput(device="cuda", l: int = 32, n_walkers: int = 4096, n_sweeps: int = 5,
                              reps: int = 5) -> dict:
    """Kawasaki exchange walker-sweeps per second on the L=32 Hubbard chain,
    each call of n_sweeps one launch of the exchange kernel."""
    device = torch.device(device)
    n = 2 * l
    machine = RBM(n_inputs=n, n_hiddens=n, dtype=torch.float32)
    ham = HubbardChain(n_sites=n, u=4.0, t=1.0, n_up=5, n_down=5, pbc=True)
    work = machine.make_work(machine.init_params(make_generator(0, device)))
    state = init_state(work, ham.init_spins(make_generator(1, device), n_walkers), make_generator(2, device))
    bonds = torch.as_tensor(ham.bonds, dtype=torch.int32, device=device)
    state = kawasaki.exchange_sweeps(work, state, bonds, n_sweeps, ham.n_unit_steps)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        state = kawasaki.exchange_sweeps(work, state, bonds, n_sweeps, ham.n_unit_steps)
    _sync(device)
    dt = time.perf_counter() - t0
    return _emit({"metric": "kawasaki_exchange_walker_sweeps_per_sec_L32_hubbard",
                  "value": round(n_walkers * n_sweeps * reps / dt, 1), "unit": "sweeps/s", "vs_baseline": None,
                  "device": _device_name(device)})


def bench_sweep_throughput(device="cuda", n: int = 64, alpha: int = 4, n_walkers: int = 8192,
                           sweeps_per_call: int = 20, reps: int = 5) -> dict:
    """Metropolis walker-sweeps per second at the flagship shape, each call of
    sweeps_per_call one launch of the sweep kernel."""
    device = torch.device(device)
    machine, ham, work, state = _flagship_state(device, n, alpha, n_walkers)
    h = machine.n_hidden
    schedule = torch.as_tensor(ham.schedule(), dtype=torch.int32, device=device)
    state = metropolis.sweeps(work, state, schedule, sweeps_per_call)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        state = metropolis.sweeps(work, state, schedule, sweeps_per_call)
    _sync(device)
    dt = time.perf_counter() - t0
    sweeps_per_sec = n_walkers * sweeps_per_call * reps / dt
    flops = sweeps_per_sec * _sweep_flops(n, h)
    return _emit({"metric": "metropolis_walker_sweeps_per_sec_chip_N64_RBMTrSymm_a4", "value": round(sweeps_per_sec, 1),
                  "unit": "sweeps/s", "vs_baseline": None, "gflops_analytic": round(flops / 1e9, 1),
                  **_shares(device, flops, sweeps_per_sec * n * h, "sweep"), "device": _device_name(device)})


def main(argv=None) -> list[dict]:
    """Print the five metric lines (the headline sweep rate last); return them."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    device = parser.parse_args(argv).device
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device (pass --device cpu for the plain versions)")
    return [
        bench_energy_rel_err(device),
        bench_sr_solves(device),
        bench_energy_kernel(device),
        bench_exchange_throughput(device),
        bench_sweep_throughput(device),
    ]


if __name__ == "__main__":
    main()
