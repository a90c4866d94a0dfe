#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed with its seconds:
1. a CUDA device must be present (else exit 1); print its name and power limit;
2. build the CUDA kernels with nvcc (one process per source, in parallel);
3. at full width (N=64, H=256, K=8192) hold each kernel against its plain
   PyTorch version on the same inputs and time both with CUDA events;
4. drive the flagship configuration through the user's entry points
   (VMC.init, warm_up, run) and check that it ran through both kernels,
   never through a plain version, with finite energies.

Then one JSON line with the kernels' numbers, the card's name and power
limit, and, as the last line, {"ok": true, "device": {...}}. Any failed
check exits non-zero without that line. A watchdog ends the run after
LIMIT_S seconds. The script imports no JAX and nothing of the JAX package,
and writes nothing but the port's gitignored build directory.
"""

from __future__ import annotations

import json
import math
import os
import signal
import subprocess
import sys
import threading
import time

LIMIT_S = 300
N, ALPHA, K = 64, 4, 8192  # RBMTrSymm(n_inputs=64, alpha=4): H = 256, V = 261
SR_STEPS, WARM_SWEEPS = 20, 100
# The init weights (~0.006) leave |y| ~ 0.05, where ln cosh is nearly
# quadratic; the comparisons scale them so that |y| ~ 0.5.
PARAM_SCALE = 10.0
ENERGY_RTOL = 1e-5  # max|kernel - plain| / max|plain| over walkers
SWEEP_MISMATCH_MAX = 1e-3  # share of walkers whose decisions differ (near-ties u ~ exp(2 dln))
SWEEP_Y_ATOL = 1e-5  # y on walkers with identical decisions
SWEEP_LNPSI_ATOL = 1e-4  # ln psi on those walkers
CACHE_ATOL = 2e-4  # y carried through the warm-up's 6400 proposals vs a fresh forward
# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores, HBM3.
PEAK_F32_FLOPS, PEAK_BYTES_S = 67e12, 3.35e12
# Operations per (walker, proposal or site, hidden unit), counting exp, sin,
# cos, log and atan2 as one each: y' (4), |x| and exp (3), sin/cos (2),
# 1+-e (2), the planes (2-3), |.|^2 (3), log and scaling (4), sum (1-4).
SWEEP_OPS, ENERGY_OPS = 20, 25

_phase = ["start"]


def _on_alarm(signum, frame):
    raise SystemExit(f"chip_smoke: watchdog: over {LIMIT_S} s, in phase {_phase[0]}")


def _hard_stop():
    print(f"chip_smoke: watchdog: stuck in phase {_phase[0]}; exiting", file=sys.stderr, flush=True)
    os._exit(3)


def _enter(name: str, t0: float) -> None:
    _phase[0] = name
    print(f"# [{time.perf_counter() - t0:7.2f} s] phase {name}", flush=True)


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(torch, fn, reps: int) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _bound_ms(ops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _profile_steps(torch, vmc, params, state, step0: int, n_steps: int = 5) -> None:
    """Device time by kernel over a few more SR steps (torch.profiler), and
    the share of the window in which the card ran no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for i in range(n_steps):
            params, state, _ = vmc.step(params, state, step0 + i)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    rows = [  # device-side events only (kernels, copies): host ops would count their kernels twice
        (ev.self_device_time_total / 1e3 / n_steps, ev.count / n_steps, ev.key)
        for ev in prof.key_averages()
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
    ]
    busy = sum(r[0] for r in rows)
    if busy == 0:
        print("step profile: the profiler recorded no device time (device busy share not measured)")
        return
    print(f"step profile ({n_steps} steps, profiler on): wall {wall_ms / n_steps:.3f} ms/step, device busy "
          f"{busy:.3f} ms/step in {sum(r[1] for r in rows):.0f} device events/step, idle share {1.0 - busy * n_steps / wall_ms:.3f}")
    for ms, count, key in sorted(rows, reverse=True)[:8]:
        print(f"  {ms:8.4f} ms/step  {count:6.1f} calls/step  {key[:90]}")


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def main() -> int:
    t0 = time.perf_counter()
    signal.signal(signal.SIGALRM, _on_alarm)
    signal.alarm(LIMIT_S)
    backstop = threading.Timer(LIMIT_S + 30, _hard_stop)  # for a call stuck in native code
    backstop.daemon = True
    backstop.start()

    _enter("1 device", t0)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = _smi()
    print(f"device: {kind} (count {count}, torch {torch.__version__}, CUDA {torch.version.cuda})")
    print(f"nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from neural_network_quantum_state_tpu_torch import VMC, VMCConfig
    from neural_network_quantum_state_tpu_torch.hamiltonians import LITFIChain
    from neural_network_quantum_state_tpu_torch.models import RBMTrSymm
    from neural_network_quantum_state_tpu_torch.ops import build, engine
    from neural_network_quantum_state_tpu_torch.ops.energy import offdiag_sum_cuda, offdiag_sum_plain
    from neural_network_quantum_state_tpu_torch.ops.rng import make_generator, random_spins, uniform_block
    from neural_network_quantum_state_tpu_torch.ops.sweep import sweep_cuda, sweep_plain

    _enter("2 build", t0)
    for b in build.build().values():
        print(f"built {b.name}: {b.seconds:.1f} s -> {b.path.name}")
        for line in b.ptxas:
            print(f"  {line}")

    _enter("3 kernels vs plain", t0)
    dev = torch.device("cuda")
    machine = RBMTrSymm(n_inputs=N, alpha=ALPHA, dtype=torch.float32)
    h = machine.n_hidden
    g = make_generator(1234, dev)
    params = {k: PARAM_SCALE * v for k, v in machine.init_params(g).items()}
    work = machine.make_work(params)
    cache, lnpsi = engine.full_forward(work, random_spins(g, K, N))
    sched = torch.as_tensor(LITFIChain(n_sites=N).schedule())

    e_kernel = offdiag_sum_cuda(work, cache)
    e_plain = offdiag_sum_plain(work, cache, lnpsi)
    torch.cuda.synchronize()
    e_abs = float((e_kernel - e_plain).abs().max())
    e_rel = e_abs / float(e_plain.abs().max())
    print(f"energy: max|kernel-plain| {e_abs:.3e}, relative to max|plain| {e_rel:.3e} (tol {ENERGY_RTOL:.0e})")
    failures = []
    if not (math.isfinite(e_rel) and e_rel <= ENERGY_RTOL):
        failures.append(f"energy kernel vs plain: {e_rel:.3e} > {ENERGY_RTOL:.0e}")

    u = uniform_block(g, (N, K))  # one sweep
    ck, lk, acc_k = sweep_cuda(work, cache, sched, u)
    cp, lp, acc_p = sweep_plain(work, cache, lnpsi, sched, u)
    torch.cuda.synchronize()
    differ = (ck.spins != cp.spins).any(dim=1)
    share = float(differ.double().mean())
    same = ~differ
    y_err = float((ck.y[same] - cp.y[same]).abs().max())
    ln_err = float((lk[same] - lp[same]).abs().max())
    print(f"sweep: walkers with other decisions {int(differ.sum())}/{K} = {share:.2e} (max {SWEEP_MISMATCH_MAX:.0e}); "
          f"on the others max|dy| {y_err:.3e} (tol {SWEEP_Y_ATOL:.0e}), max|dlnpsi| {ln_err:.3e} "
          f"(tol {SWEEP_LNPSI_ATOL:.0e}); acceptance kernel {float(acc_k) / (N * K):.4f}, plain {float(acc_p) / (N * K):.4f}")
    if share > SWEEP_MISMATCH_MAX:
        failures.append(f"sweep kernel: decision mismatch share {share:.2e}")
    if not (y_err <= SWEEP_Y_ATOL and ln_err <= SWEEP_LNPSI_ATOL):
        failures.append(f"sweep kernel: dy {y_err:.3e}, dlnpsi {ln_err:.3e}")

    timing = {
        "sweep": (_time_ms(torch, lambda: sweep_cuda(work, cache, sched, u), 20),
                  _time_ms(torch, lambda: sweep_plain(work, cache, lnpsi, sched, u), 2)),
        "energy": (_time_ms(torch, lambda: offdiag_sum_cuda(work, cache), 20),
                   _time_ms(torch, lambda: offdiag_sum_plain(work, cache, lnpsi), 3)),
    }
    for name, (k_ms, p_ms) in timing.items():
        print(f"{name}: kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms per call (CUDA events; the sweep call is one sweep)")
    _require(not failures, "; ".join(failures))
    c64, f32b = 8, 4
    sweep_bound = _bound_ms(K * N * h * SWEEP_OPS,
                            2 * K * h * c64 + 2 * K * N * f32b + 2 * K * c64 + N * K * f32b + N * h * c64 + N * c64 + K * f32b)
    energy_bound = _bound_ms(K * N * h * ENERGY_OPS, K * h * c64 + K * N * f32b + N * h * c64 + N * c64 + K * c64)

    _enter("4 flagship SR steps", t0)
    sweep_cuda.launches = offdiag_sum_cuda.launches = 0
    sweep_plain.calls = offdiag_sum_plain.calls = 0
    mem_base = torch.cuda.memory_allocated()  # what phase 3 still holds
    torch.cuda.reset_peak_memory_stats()
    t_main = time.perf_counter()
    vmc = VMC(
        RBMTrSymm(n_inputs=N, alpha=ALPHA, dtype=torch.float32),
        LITFIChain(n_sites=N, h=-0.5, j=0.866, alpha=2.5, pbc=True),
        VMCConfig(n_walkers=K, learning_rate=1e-2, solver="cg", use_fused_sweeps=True, seed=3),
    )
    params, state = vmc.init()
    state = vmc.warm_up(params, state, WARM_SWEEPS)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t_main
    peak_warm = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fresh, _ = engine.full_forward(vmc.machine.make_work(params), state.cache.spins)
    drift = float((fresh.y - state.cache.y).abs().max())
    stamps = [time.perf_counter()]
    params, state, history, _ = vmc.run(params, state, SR_STEPS, callback=lambda i, s: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    launches = {"sweep": sweep_cuda.launches, "energy": offdiag_sum_cuda.launches}
    plain_calls = sweep_plain.calls + offdiag_sum_plain.calls
    steps_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    energies = [r["energy"] for r in history]
    print(f"init + warm-up ({WARM_SWEEPS} sweeps): {t_warm:.3f} s; y drift vs fresh forward {drift:.3e} (tol {CACHE_ATOL:.0e})")
    print(f"SR steps: {len(history)}; step ms first {steps_ms[0]:.2f}, mean of the rest "
          f"{sum(steps_ms[1:]) / max(1, len(steps_ms) - 1):.2f}; cg iters {[r['cg_iters'] for r in history[-3:]]}; "
          f"acceptance {history[-1]['acceptance']:.4f}")
    print(f"peak memory above the {mem_base / 2**20:.1f} MiB held before: init + warm-up "
          f"{(peak_warm - mem_base) / 2**20:.1f} MiB, SR steps {(torch.cuda.max_memory_allocated() - mem_base) / 2**20:.1f} MiB; "
          f"last energies {energies[-3:]}")
    print(f"launches in the main path: {launches}; plain-version calls: {plain_calls}")
    _require(len(history) == SR_STEPS and all(math.isfinite(e) for e in energies), f"energies {energies}")
    _require(drift <= CACHE_ATOL, f"sweep kernel cache drift {drift:.3e}")
    _require(all(v > 0 for v in launches.values()), f"a kernel was not launched: {launches}")
    _require(plain_calls == 0, f"the main path called a plain version {plain_calls} times")
    _require(launches == {"sweep": WARM_SWEEPS + SR_STEPS, "energy": SR_STEPS},
             f"launches {launches}: expected one sweep launch per sweep and one energy launch per step")

    _enter("5 step profile", t0)
    _profile_steps(torch, vmc, params, state, SR_STEPS)

    _enter("6 report", t0)
    errs = {
        "sweep": {"max_abs_err": ln_err, "tolerance": SWEEP_LNPSI_ATOL, "mismatch_share": share},
        "energy": {"max_abs_err": e_abs, "rel_err": e_rel, "tolerance": ENERGY_RTOL},
    }
    bounds = {"sweep": sweep_bound, "energy": energy_bound}
    replaces = {
        "sweep": "neural_network_quantum_state_tpu/ops/pallas_sweep.py:100",
        "energy": "neural_network_quantum_state_tpu/ops/pallas_energy.py:61",
    }
    kernels = [
        {
            "name": name, "route": "cuda",
            "source": f"neural_network_quantum_state_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name], "launches": launches[name],
            **errs[name],
            "ms": timing[name][0], "kernel_ms": timing[name][0], "plain_ms": timing[name][1],
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": None,
        }
        for name in ("sweep", "energy")
    ]
    print(json.dumps({"kernels": kernels}))
    print(_smi())  # the card's name and power limit, as nvidia-smi prints them
    print(f"# total {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    os._exit(rc)
