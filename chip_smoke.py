#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed with its seconds:
1. a CUDA device must be present (else exit 1); print its name and power limit;
2. build the CUDA kernels with nvcc (one process per source, in parallel);
   print each instance's registers and spill bytes, and the SASS
   instructions per element of the sweep's, the energy and the exchange
   kernel's hot loops;
3. at full width hold each kernel against its plain PyTorch version on the
   same inputs and time both with CUDA events: the sweep and energy kernels
   at the LITFI flagship's N=64, H=256, K=8192 (the sweep at n_beta = 1 and
   at n_beta = 8, with its in-kernel replica exchange), the fused
   sweep + energy megakernel at that shape against the sweep kernel followed
   by the energy kernel on the same uniforms and against its plain version
   (n_beta = 1 and 8), the exchange kernel at the Hubbard flagship's N=64,
   H=64, K=4096, B=64 (one sweep of 64 proposals on its Philox stream, the
   training paths' mode, and on caller uniforms, and 5 sweeps in one launch
   on the stream); the instances with output weights c (the FFNN family) of
   the sweep (n_beta = 1 and 8) and energy kernels with a plain
   FFNN(64, 256) at that shape and of the exchange kernel with FFNN(64, 64),
   the same three ways; the sweep and energy kernels without a visible bias
   (RBMSfSymm, alpha = 4); then every kernel and instance at H = 16, 80 and
   384 (widths off the multiples of 32, small K; the exchange on caller
   uniforms and two sweeps in one launch on its stream, which reads W, or
   with c the table of its rotation, from shared memory at H = 16 and 80 and
   through L1 at 384: both branches of both instances must run); and the sweep kernel's Philox mode (its uniforms drawn on the chip)
   against the plain sweep on the same Philox stream, at n_beta = 1 and 8,
   with and without c, at full width and at H = 16, 80 and 384; 5 sweeps
   in one launch (a sampler call's mode) at full width, n_beta = 1 and 8,
   with and without c; the sweep kernel on the 8x8 square-checkerboard and
   the 9x9 three-colour schedules; the energy kernel's float64 instance
   against its plain float64 version at full width and H = 16, 80 and 384,
   with and without c, to a relative 1e-12; the exchange kernel's tempered
   instance (tempered exchange: n_beta > 1, its swap phases in the kernel)
   against the plain tempered exchange at the Hubbard flagship's shape, at
   n_beta = 4 and 8, with and without c (FFNN(64, 64)), on its Philox stream
   (one sweep and 5 in one launch) and on caller uniforms, with the
   exchange gates and every replica in its sector, and at H = 16, 80 and
   384; the hot-math chain-rate probe, both bodies at bench.py's size
   (2^22 elements, 32 bodies a chain), against its plain version to a
   relative 1e-5 of the largest |value| (the elements whose energy-body
   chain takes a phase near the branch cut left out, their share bounded);
4. drive the LITFI flagship through the user's entry points (VMC.init,
   warm_up, run) and check that it ran through the sweep and energy
   kernels, never through a plain version, with finite energies: one sweep
   launch per sampler call (1 for the warm-up, 1 per step);
5. drive the Hubbard flagship (the L=32 trap chain, 500 warm-up sweeps, 20
   SR steps) the same way and check that each sampler call ran as one
   launch of the exchange kernel (1 for the warm-up, 1 per step), that every
   walker kept 5 up and 5 down particles, and that the energies are finite;
6. drive the tempered LITFI flagship (n_beta = 4: 2048 chains of 4
   replicas, the collapse escalation's default) the same way: every sweep
   through the sweep kernel with its ladder, the energy kernel on the
   beta = 1 replicas, no plain version, finite energies;
7. drive the FFNN flagship (FFNNTrSymm(64, alpha=4) on the LITFI chain,
   100 warm-up sweeps, 20 SR steps) the same way: every sweep and every
   energy through the kernels' instances with c, no plain version;
8. drive FFNN(64, 64) on the Hubbard flagship's trap chain (200 warm-up
   sweeps, 5 SR steps): each sampler call one launch of the exchange
   kernel's instance with c (1 + 5), the particle sectors kept;
9. the SR solvers on the card: one (O, E) of the warmed LITFI flagship in
   float64, at the first step's lambda (90) and at its floor (1e-2); on
   S + lambda diag S, cholesky, svd, CG and MINRES-QLP (tol 1e-10) against
   the LU solve; sr_dense_solve's lu, cholesky and svd (with the dense
   ridge) against each other; minSR against the dense solve at its absolute
   ridge; each to a relative 1e-8. At the floor CG and MINRES-QLP run also
   at tol 1e-12, held to 1e-8, and their tol 1e-10 runs are held to
   cond(A) times their relative residual;
10. 10 SR steps of the LITFI flagship with each solver and mode (lu,
   cholesky, svd, minsr, sgd, minresqlp, auto, auto with CG capped at 2
   iterations, which must fall back to MINRES-QLP, cholesky with 3
   sampling rounds, cg with precond_ema, energy_dtype float64 with the RBM
   and with FFNNTrSymm(64, alpha=4), energy_dtype "compensated", block
   moves), each through VMC.init, warm_up and run: one sweep launch per
   sampler call, the energy kernel's float32 instance once per round (its
   float64 instance once per step for energy_dtype=float64, the one with c
   for the FFNN; none for the compensated sum), no plain version, finite
   energies;
11. the Hubbard flagship with minSR (the recorded production run's
   options: float32 solve, 5 steps per host loop), 500 warm-up sweeps and
   20 steps: 1 + 20 exchange launches, every sector kept;
12. 2D dense SR: FFNN(64, 64) on the 8x8 J1-J2 checkerboard, K=4096, lu,
   2 sampling rounds per step, 100 warm-up sweeps and 10 steps, through
   the sweep and energy kernels' instances with c;
13. the megakernel A/B (``megakernel_ab``, n_beta = 1 and 8): its
   cross-check and the time of each arm;
14. drive the tempered Hubbard flagship (n_beta = 4, the collapse
   escalation's default: 1024 chains of 4 replicas, 500 warm-up sweeps, 20
   SR steps) the same way: each sampler call one launch of the exchange
   kernel's tempered instance (1 + 20), every replica in its sector, finite
   energies of the beta = 1 replicas, no plain version; then FFNN(64, 64)
   on the same ladder (200 warm-up sweeps, 5 SR steps) through the tempered
   instance with c (1 + 5);
15. the port's benchmark (``neural_network_quantum_state_tpu_torch.bench``)
   at bench.py's sizes: its five lines, every number finite, the N=16 TFI
   error below bench.py's bar of 1e-4, every kernel it runs counted (the
   sweep, energy, exchange and chain-rate kernels), no plain version;
16. the device time of each kernel and instance on phase 3's inputs
   (torch.profiler; the sweep and exchange in the main paths' Philox mode,
   and also on caller uniforms), beside the instance's registers and spill
   bytes from the build, the exchange's and the sweep's 5-sweep launches,
   the energy kernel's float64 instance, the exchange's tempered instance
   and the chain-rate probe;
17. profile 5 more LITFI SR steps, 18. 5 more Hubbard SR steps, 19. 5 more
   FFNN flagship SR steps, 20. 3 more Hubbard minSR steps, 21. 3 more 2D
   dense SR steps, 22. 5 more tempered Hubbard SR steps.
The profiler runs only after the timed phases 4 to 15, so that it cannot
disturb their times.

Then one JSON line with the kernels' numbers, the card's name and power
limit, and, as the last line, {"ok": true, "device": {...}}. Any failed
check exits non-zero without that line. A watchdog ends the run after
LIMIT_S seconds. The script imports no JAX and nothing of the JAX package,
and writes nothing but the port's gitignored build directory.

    python3 chip_smoke.py --sass LIB.so ...

prints phase 2's SASS counts of the given kernel libraries (a build of
another tree, say) and exits; it needs ``cuobjdump`` and no card.
"""

from __future__ import annotations

import json
import math
import os
import re
import signal
import subprocess
import sys
import threading
import time

LIMIT_S = 300
N, ALPHA, K = 64, 4, 8192  # RBMTrSymm(n_inputs=64, alpha=4): H = 256, V = 261
SR_STEPS, WARM_SWEEPS = 20, 100
# Hubbard flagship: the L=32 trap chain, RBM(n_inputs=64, n_hiddens=64)
# (V = 4224), two flavor rings (B = 64 bonds), 64 proposals per sweep.
HUB_L, HUB_H, HUB_K, HUB_PARTICLES = 32, 64, 4096, 5
HUB_WARM_SWEEPS, HUB_SR_STEPS, HUB_TRAP = 500, 20, 0.05
# The RBM family's init weights (~0.006) leave |y| ~ 0.05, where ln cosh is
# nearly quadratic; the comparisons scale them so that |y| ~ 0.5. The FFNN
# family's init already gives |Re y| ~ 0.5 but keeps the imaginary planes at
# 0.1 of the real ones; the comparisons scale those planes alone, so that
# both planes of y and of the output weights c are alike.
PARAM_SCALE = 10.0
# FFNN flagship: FFNNTrSymm(n_inputs=64, alpha=4) (H = 256, V = 264) on the
# LITFI flagship's chain; FFNN(64, 64) (V = 4224) on the Hubbard trap chain.
FFNN_HUB_H, FFNN_HUB_WARM_SWEEPS, FFNN_HUB_SR_STEPS = 64, 200, 5
ENERGY_RTOL = 1e-5  # max|kernel - plain| / max|plain| over walkers
SWEEP_MISMATCH_MAX = 1e-3  # share of walkers whose decisions differ (near-ties u ~ exp(2 dln))
SWEEP_Y_ATOL = 1e-5  # y on walkers with identical decisions
SWEEP_LNPSI_ATOL = 1e-4  # ln psi on those walkers
EXCHANGE_MISMATCH_MAX, EXCHANGE_Y_ATOL, EXCHANGE_LNPSI_ATOL = 1e-3, 1e-5, 1e-4  # as for the sweep
CACHE_ATOL = 2e-4  # y carried through the warm-up's 6400 proposals vs a fresh forward
TEMPERED_NBETA, CHECK_NBETA = 4, 8  # the tempered flagship's ladder; the phase-3 and A/B ladder
# Widths off the multiples of 32 (the e2e oracle, the precision anchors,
# the Binder N=96 leg) at small K; the same tolerances as above.
WIDTHS, WIDTH_N, WIDTH_K = (16, 80, 384), 32, 512
WIDTH_MISMATCH_MAX = 1e-2  # at K=512 one near-tie is 2e-3 of the walkers
OFFDIAG_RTOL = 1e-5  # megakernel vs the two kernels / plain, on walkers with the same decisions
# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores, HBM3.
PEAK_F32_FLOPS, PEAK_BYTES_S = 67e12, 3.35e12
# Operations per (walker, proposal or site, hidden unit), counting exp, sin,
# cos, log and atan2 as one each: y' (4), |x| and exp (3), sin/cos (2),
# 1+-e (2), the planes (2-3), |.|^2 (3), log and scaling (4), sum (1-4).
SWEEP_OPS, ENERGY_OPS = 20, 25
# With output weights c: the atan2 of the second plane and the two products
# of Re(c l) per (walker, proposal, hidden unit); the four products of the
# complex rotation c (l' - l) per (walker, site, hidden unit).
SWEEP_OPS_C, ENERGY_OPS_C = SWEEP_OPS + 3, ENERGY_OPS + 4
# The exchange proposal: 22 per hidden unit (y' takes a second W row), and
# 2 per bond for the active mask (a product and a compare); the count and
# pick over the mask (a popcount per 32 bonds) are left out.
EXCHANGE_OPS_HIDDEN, EXCHANGE_OPS_BOND = 22, 2
EXCHANGE_OPS_HIDDEN_C = EXCHANGE_OPS_HIDDEN + 3  # as SWEEP_OPS_C
EXCHANGE_MULTI_SWEEPS = 5  # the sweeps of the one-launch comparison
# A replica-exchange phase per walker row: the difference of Re ln psi, the
# beta-scaled min, the exp, the compare and the select.
SWAP_OPS = 5
MULTI_SWEEPS = 5  # the sweep kernel's one-launch comparison (a sampler call's mode)
# The energy kernel's float64 instance: its bar against the plain float64
# sum, and the H100 SXM's float64 rate outside the tensor cores (NVIDIA data
# sheet), over which its operations are bounded.
F64_ENERGY_RTOL, PEAK_F64_FLOPS = 1e-12, 34e12
SOLVER_CHECK_RTOL = 1e-8  # the on-card solver cross-check (phase 9)
# its CG and MINRES-QLP tolerances: 1e-10, held to the bar at the first
# step's lambda and at the floor to what its residual allows there (cond(A)
# times the relative residual); and at the floor also 1e-12, held to the bar
SOLVER_CHECK_TOLS, SOLVER_CHECK_MAX_ITERS = (1e-10, 1e-12), 1000
SOLVER_STEPS = 10  # SR steps of each solver and mode (phase 10)
AUTO_FORCED_CAP = 2  # cg_max_iters of phase 10's auto run that must fall back to MINRES-QLP
# 2D dense SR (the reference's 2D drivers): FFNN(64, 64) on the 8x8 J1-J2
# checkerboard (h=-1.5, J1=-1, J2=0.3, pbc), K=4096, lu, 2 sampling rounds
TWO_D_L, TWO_D_H, TWO_D_K, TWO_D_WARM, TWO_D_STEPS, TWO_D_ROUNDS = 8, 64, 4096, 100, 10, 2
TRI_L = 9  # the three-colour schedule's comparison: the 9x9 triangular lattice
NEW_PROFILE_STEPS = 3  # the profiles of the Hubbard minSR and 2D paths
# each wrapper's CUDA kernel, as the profiler names it (the energy kernel's
# float64 instance: "energy_f64"; the exchange kernel's tempered instance:
# "exchange_tempered")
KERNEL_NAMES = {"sweep": "sweep_kernel", "energy": "offdiag_kernel", "exchange": "exchange_kernel",
                "sweep_energy": "sweep_energy_kernel", "energy_f64": "offdiag_kernel_f64",
                "exchange_tempered": "exchange_kernel", "chain_rate": "chain_kernel", "chain_rate_energy": "chain_kernel"}
# The hot-math chain-rate probe: bench.py's 2^22 elements and 32 bodies a
# chain; its bar against the plain chain (max|kernel - plain| over both
# outputs relative to their largest |value|), and the share of elements
# whose energy-body chain takes a phase within BRANCH_CUT_TOL of pi, left
# out of that comparison (0.40% of these inputs in the plain chain); float
# operations per body (a fused multiply-add counts two: the candidate move,
# the log-cosh with its reduced cos or its polynomial atan2, the mix) and
# special-function-unit results per body (ex2, lg2; the energy's rcp), at
# the H100 SXM's 16 MUFU results per SM per clock on 132 SMs at its 1.98
# GHz boost clock (NVIDIA's data sheet and CUDA's throughput table).
CHAIN_RTOL, CHAIN_NEAR_CUT_MAX = 1e-5, 1e-2
CHAIN_OPS, CHAIN_MUFU = {"sweep": 38, "energy": 60}, {"sweep": 2, "energy": 3}
PEAK_MUFU_S = 132 * 16 * 1.98e9
BENCH_REL_ERR_BAR = 1e-4  # bench.py's precision bar for its N=16 TFI error (bench.py:29)

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


def _device_ms(torch, fn, reps: int, kernel: str) -> float | None:
    """Mean device time of the CUDA kernel whose name contains `kernel`
    over `reps` calls of fn (torch.profiler); None if the profiler saw none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA and kernel in ev.key]
    count = sum(ev.count for ev in evs)
    return sum(ev.self_device_time_total for ev in evs) / 1e3 / count if count else None


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
    ranked = sorted(rows, reverse=True)
    always = (*KERNEL_NAMES.values(), "conj")  # the kernels, and the conjugate copies of the CG solve
    for ms, count, key in ranked[:8] + [r for r in ranked[8:] if any(k in r[2] for k in always)]:
        print(f"  {ms:8.4f} ms/step  {count:6.1f} calls/step  {key[:90]}")


# the template parameters of each kernel after R: C (output weights c), T
# (the sweep's tempered instance, n_beta > 1) and M (the sweep's launch of
# more than one sweep with c), as the instances are named
TEMPLATE_BOOLS = {"sweep": "ctm", "energy": "c", "exchange": "ct", "sweep_energy": "t", "chain_rate": ""}


def _ptxas_table(name: str, lines) -> dict:
    """{instance: 'registers[+spill bytes B]'} from the ptxas -v lines of one
    kernel library; an instance is R = ceil(H/32) (the exchange kernel: G x U,
    its lanes per walker and units per lane) followed by the letters of its
    true template flags (c: output weights, t: tempered, m: many sweeps) and d for the
    energy kernel's float64 instance."""
    out, key = {}, None
    for line in lines:
        m = re.search(r"_kernel(_f64)?I((?:L[ib]\d+E)+)E", line)
        if "Compiling entry function" in line and m:
            args = re.findall(r"L([ib])(\d+)E", m.group(2))
            ints = "x".join(v for t, v in args if t == "i")
            flags = [int(v) for t, v in args if t == "b"]
            key = ints + "".join(f for f, v in zip(TEMPLATE_BOOLS[name], flags) if v) + ("d" if m.group(1) else "")
            spill = 0
        elif key is not None and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif key is not None and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out[key] = f"{regs}" + (f"+{spill}B" if spill else "")
            key = None
    return out


# The hot loop's SASS: the R = 8 instances (H = 256) of the sweep (n_beta = 1,
# or a build without the tempered flag) and energy kernels, by their mangled
# template flags after R, and the floating-point and special-function opcodes.
SASS_R = 8
SASS_INSTANCES = (("sweep_kernel", "Lb0E(?:Lb0E){0,2}", "sweep RBM"), ("sweep_kernel", "Lb1E(?:Lb0E){0,2}", "sweep has_c"),
                  ("offdiag_kernel", "Lb0E", "energy RBM"), ("offdiag_kernel", "Lb1E", "energy has_c"))
SASS_FP = ("FFMA", "FMUL", "FADD", "FMNMX", "FSETP", "FSEL", "FRND", "MUFU")
# The exchange kernel's instance of the Hubbard flagship (H = 64): G = 8 lanes
# per walker, U = 8 units per lane, n_beta = 1 (T = false); its proposal loop
# with W in shared memory.
SASS_EXCHANGE_G, SASS_EXCHANGE_U = 8, 8


def _loops(ins):
    """The backward-branch loops of a function's (address, opcode) list, as
    lists of opcodes."""
    out = []
    for a, op in ins:
        m = re.search(r"BRA (?:\S+ )?0x([0-9a-f]+)", op)
        if m and int(m.group(1), 16) < a:
            out.append([o for x, o in ins if int(m.group(1), 16) <= x <= a])
    return out


def _per_element(label, body, per) -> str:
    ops = [re.sub(r"^@!?U?P\w+\s+", "", o).split()[0].split(".")[0] for o in body]
    fp, mufu, ldl = sum(o in SASS_FP for o in ops), ops.count("MUFU"), ops.count("LDL")
    return (f"{label}: loop of {len(body)} instructions for {per} elements: "
            f"{len(body) / per:.1f} per element, {fp / per:.1f} floating-point/MUFU "
            f"(MUFU {mufu / per:.2f}, LDL {ldl / per:.2f})")


def _sass_per_element(text: str) -> list[str]:
    """Static SASS instructions per (site or proposal, hidden unit) element
    in the hot loop of each instance above in `text`, a library's
    ``cuobjdump -sass``. Sweep and
    energy: the innermost backward-branch loop with at least R loads and five
    shuffles, over R units times its sites per iteration (4 where it holds
    the energy kernel's reduce-scatter of 4 sites, which has four lane-16
    exchanges where a warp sum has one). Exchange: the proposal loop (the
    smallest loop with the hidden sum's log2 G butterfly shuffles, the two
    draw shuffles and 2U shared-memory loads of W) over the U units of a
    lane (LDS.64 of w, or LDS.128 of the rotation's table where a build
    has it). Cold paths inside the loop count too (a library sincosf's slow
    reduction, the Philox refill, the words past the registers), so this
    bounds the issued instructions per element from above."""
    funcs = {}
    for chunk in re.split(r"\n\s*Function : ", text)[1:]:
        name, body = chunk.split("\n", 1)
        funcs[name.strip()] = [(int(a, 16), op) for a, op in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    lines = []
    for kernel, flags, label in SASS_INSTANCES:
        names = [n for n in funcs if re.search(rf"{kernel}ILi{SASS_R}E{flags}E", n)]
        if not names:
            continue
        loops = [body for body in _loops(funcs[names[0]])
                 if sum("LDG" in o for o in body) >= SASS_R and sum("SHFL" in o for o in body) >= 5]
        if not loops:
            lines.append(f"{label}: no hot loop found")
            continue
        body = min(loops, key=len)
        sites = 4 if sum(bool(re.search(r"SHFL\.BFLY .*, 0x10,", o)) for o in body) == 4 else 1
        lines.append(_per_element(f"{label} (R={SASS_R})", body, SASS_R * sites))
    g, u = SASS_EXCHANGE_G, SASS_EXCHANGE_U
    for flag, label in (("0", "exchange RBM"), ("1", "exchange has_c")):
        names = [n for n in funcs if re.search(rf"exchange_kernelILi{g}ELi{u}ELb{flag}ELb0E", n)]
        if not names:
            continue
        loops = [body for body in _loops(funcs[names[0]])
                 if sum("SHFL.BFLY" in o for o in body) >= int(math.log2(g)) and sum("SHFL.IDX" in o for o in body) >= 2
                 and sum(bool(re.search(r"LDS\.(64|128)", o)) for o in body) >= 2 * u]
        if not loops:
            lines.append(f"{label}: no proposal loop found")
            continue
        lines.append(_per_element(f"{label} (G={g}, U={u}, W in shared memory)", min(loops, key=len), u))
    return lines


def _sass_report(libs) -> list[str]:
    """Phase 2's SASS counts of the libraries `libs`, or why there are none."""
    from pathlib import Path

    from neural_network_quantum_state_tpu_torch.ops.build import nvcc

    cuobjdump = Path(nvcc()).with_name("cuobjdump")
    if not cuobjdump.exists():
        return [f"SASS per element: not measured ({cuobjdump} not found)"]
    # one disassembler process per library, all started together
    procs = [(lib, subprocess.Popen([str(cuobjdump), "-sass", str(lib)], stdout=subprocess.PIPE, text=True))
             for lib in libs]
    lines = []
    try:
        for lib, proc in procs:
            text, _ = proc.communicate(timeout=120)
            if proc.returncode != 0:
                raise RuntimeError(f"cuobjdump failed on {lib} (rc {proc.returncode})")
            lines += [f"{Path(lib).name}: {line}" for line in _sass_per_element(text)]
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return lines


def _ptxas_summary(table: dict) -> str:
    """'<instance>:<registers>[+<spill>B]' in the order of R."""
    items = sorted(table.items(), key=lambda kv: ([int(v) for v in re.findall(r"\d+", kv[0])], kv[0]))
    return " ".join(f"{k}:{v}" for k, v in items) or "(already built)"


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def _compare(label, ck, lk, cp, lp, mismatch_max, y_atol, ln_atol, failures, cut=False):
    """Kernel vs plain states from the same inputs and uniforms: the share
    of walkers with other decisions, and y and ln psi on the others. With
    output weights c (cut=True) a walker whose final y has a hidden unit
    near the principal log-cosh's branch cut in either state, where ln psi
    may jump by 2 pi i c_j between them, counts with the other decisions.
    Appends to `failures`; returns (share, ln_err, mask of agreeing walkers)."""
    from neural_network_quantum_state_tpu_torch.ops.logcosh import near_branch_cut

    differ = (ck.spins != cp.spins).any(dim=1)
    near = (near_branch_cut(ck.y) | near_branch_cut(cp.y)) & ~differ if cut else differ.new_zeros(differ.shape)
    same = ~(differ | near)
    share = float((~same).double().mean())
    y_err = float((ck.y[same] - cp.y[same]).abs().max())
    ln_err = float((lk[same] - lp[same]).abs().max())
    k = differ.shape[0]
    print(f"{label}: walkers with other decisions {int(differ.sum())}" + (f" + near the cut {int(near.sum())}" if cut else "")
          + f"/{k} = {share:.2e} (max {mismatch_max:.0e}); "
          f"on the others max|dy| {y_err:.3e} (tol {y_atol:.0e}), max|dlnpsi| {ln_err:.3e} (tol {ln_atol:.0e})")
    if share > mismatch_max:
        failures.append(f"{label}: decision mismatch share {share:.2e}")
    if not (y_err <= y_atol and ln_err <= ln_atol):
        failures.append(f"{label}: dy {y_err:.3e}, dlnpsi {ln_err:.3e}")
    return share, ln_err, same


def _rel(a, b, mask=slice(None)) -> float:
    """max|a - b| / max|b| over the walkers in mask (all by default)."""
    return float((a[mask] - b[mask]).abs().max() / b[mask].abs().max())


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

    from neural_network_quantum_state_tpu_torch import VMC, VMCConfig, megakernel_ab
    from neural_network_quantum_state_tpu_torch import bench as port_bench
    from neural_network_quantum_state_tpu_torch.hamiltonians import HubbardChain, LITFIChain, TFICheckerBoard, TFITRI
    from neural_network_quantum_state_tpu_torch.models import FFNN, FFNNTrSymm, RBM, RBMSfSymm, RBMTrSymm
    from neural_network_quantum_state_tpu_torch.ops import build, engine
    from neural_network_quantum_state_tpu_torch.ops.chain_rate import (
        BODIES, CHAIN_LEN, N_ELEMS, chain_cuda, chain_near_cut, chain_plain, probe_inputs,
    )
    from neural_network_quantum_state_tpu_torch.ops.energy import offdiag_near_cut, offdiag_sum_cuda, offdiag_sum_plain
    from neural_network_quantum_state_tpu_torch.ops.exchange import (
        exchange_cuda, exchange_plain, kernel_lanes, stages_w, tempered_exchange_plain,
    )
    from neural_network_quantum_state_tpu_torch.ops.rng import (
        ExchangeDraws, PhiloxDraws, make_generator, philox_key, random_spins, uniform_block,
    )
    from neural_network_quantum_state_tpu_torch.ops.sweep import sweep_cuda, sweep_plain
    from neural_network_quantum_state_tpu_torch.ops.sweep_energy import sweeps_offdiag_cuda, sweeps_offdiag_plain
    from neural_network_quantum_state_tpu_torch.optim import solvers
    from neural_network_quantum_state_tpu_torch.optim.minres import sr_minres_solve
    from neural_network_quantum_state_tpu_torch.optim.sr import (
        LAMBDA_MIN, build_s_matrix, force_vector, lambda_schedule, sr_cg_solve, sr_dense_solve, sr_minsr_solve,
    )

    wrappers = {"sweep": sweep_cuda, "energy": offdiag_sum_cuda, "exchange": exchange_cuda,
                "sweep_energy": sweeps_offdiag_cuda, "chain_rate": chain_cuda}
    plains = (sweep_plain, offdiag_sum_plain, exchange_plain, sweeps_offdiag_plain, chain_plain)

    def reset_counts():
        for fn in wrappers.values():
            fn.launches = 0
        offdiag_sum_cuda.launches_f64 = offdiag_sum_cuda.launches_f64_c = 0
        exchange_cuda.launches_tempered = exchange_cuda.launches_tempered_c = 0
        for fn in plains:
            fn.calls = 0

    def read_counts():
        """The launches of each kernel ("energy_f64": the energy kernel's
        float64 instances, "energy_f64_c": those of them with c;
        "exchange_tempered": the exchange kernel's tempered instance, counted
        in "exchange" too, "exchange_tempered_c": those of them with c) and
        the calls of all plain versions (the plain tempered exchange calls
        the plain exchange)."""
        counts = {name: fn.launches for name, fn in wrappers.items()}
        counts["energy_f64"] = offdiag_sum_cuda.launches_f64
        counts["energy_f64_c"] = offdiag_sum_cuda.launches_f64_c
        counts["exchange_tempered"] = exchange_cuda.launches_tempered
        counts["exchange_tempered_c"] = exchange_cuda.launches_tempered_c
        return counts, sum(fn.calls for fn in plains)

    def expect(**want):
        """The launch counts of a path: the given ones, 0 for every other kernel."""
        return {name: want.get(name, 0)
                for name in (*wrappers, "energy_f64", "energy_f64_c", "exchange_tempered", "exchange_tempered_c")}

    hub_v = tuple(float(x) for x in [HUB_TRAP * (i - (HUB_L - 1) / 2.0) ** 2 for i in range(HUB_L)] * 2)
    hubbard = HubbardChain(n_sites=2 * HUB_L, u=4.0, t=1.0, n_up=HUB_PARTICLES, n_down=HUB_PARTICLES, pbc=True, v=hub_v)

    def sector_ok(spins) -> bool:
        up, dn = (spins[:, :HUB_L] > 0).sum(1), (spins[:, HUB_L:] > 0).sum(1)
        return bool(((up == HUB_PARTICLES) & (dn == HUB_PARTICLES)).all())

    _enter("2 build", t0)
    ptxas, built = {}, build.build()
    for b in built.values():
        ptxas[b.name] = _ptxas_table(b.name, b.ptxas)
        print(f"built {b.name}: {b.seconds:.1f} s -> {b.path.name}; registers per instance "
              f"(R = ceil(H/32), c: with c, t: tempered): {_ptxas_summary(ptxas[b.name])}")
    _require(set(built) == set(build.KERNELS), f"built {sorted(built)}, expected {sorted(build.KERNELS)}")
    for line in _sass_report([built[name].path for name in ("sweep", "energy", "exchange")]):
        print(f"SASS per element: {line}")

    _enter("3 kernels vs plain", t0)
    dev = torch.device("cuda")
    machine = RBMTrSymm(n_inputs=N, alpha=ALPHA, dtype=torch.float32)
    h = machine.n_hidden
    g = make_generator(1234, dev)
    params = {k: PARAM_SCALE * v for k, v in machine.init_params(g).items()}
    work = machine.make_work(params)
    cache, lnpsi = engine.full_forward(work, random_spins(g, K, N))
    sched = torch.as_tensor(LITFIChain(n_sites=N).schedule())
    failures = []

    def energy_vs_plain(label, w_, c_, ln_, tol, max_share):
        """Kernel vs plain off-diagonal sums: max|difference| / max|plain|
        over the walkers away from the branch cut (all of them without c),
        whose share must stay under max_share. Returns (rel, abs, share)."""
        near = offdiag_near_cut(w_, c_) if w_.c is not None else torch.zeros(c_.y.shape[0], dtype=torch.bool, device=dev)
        got, want = offdiag_sum_cuda(w_, c_), offdiag_sum_plain(w_, c_, ln_)
        far = ~near
        e_abs_ = float((got[far] - want[far]).abs().max())
        rel = e_abs_ / float(want[far].abs().max())
        near_share = float(near.double().mean())
        print(f"{label}: max|kernel-plain| {e_abs_:.3e}, relative to max|plain| {rel:.3e} (tol {tol:.0e})"
              + (f" on the walkers away from the cut; near the cut {int(near.sum())}/{near.shape[0]} "
                 f"(max share {max_share:.0e})" if w_.c is not None else ""))
        if not (math.isfinite(rel) and rel <= tol and near_share <= max_share):
            failures.append(f"{label}: relative error {rel:.3e}, near-cut share {near_share:.2e}")
        return rel, e_abs_, near_share

    e_rel, e_abs, _ = energy_vs_plain("energy", work, cache, lnpsi, ENERGY_RTOL, 0.0)

    u = uniform_block(g, (N, K))  # one sweep
    u_swap = uniform_block(g, (1, 2, K))  # its two swap phases, for the ladder
    ck, lk, acc_k = sweep_cuda(work, cache, sched, u)
    cp, lp, acc_p = sweep_plain(work, cache, lnpsi, sched, u)
    share, ln_err, _ = _compare("sweep", ck, lk, cp, lp, SWEEP_MISMATCH_MAX, SWEEP_Y_ATOL, SWEEP_LNPSI_ATOL, failures)
    print(f"sweep: acceptance kernel {float(acc_k) / (N * K):.4f}, plain {float(acc_p) / (N * K):.4f}")

    # the in-kernel ladder: one sweep and its swap phases at n_beta = 8
    tk, tlk, rows_k = sweep_cuda(work, cache, sched, u, CHECK_NBETA, u_swap, rows=True)
    tp, tlp, rows_p = sweep_plain(work, cache, lnpsi, sched, u, CHECK_NBETA, u_swap, rows=True)
    t_share, t_ln_err, _ = _compare(f"sweep n_beta={CHECK_NBETA}", tk, tlk, tp, tlp, SWEEP_MISMATCH_MAX, SWEEP_Y_ATOL,
                                    SWEEP_LNPSI_ATOL, failures)
    swaps_k, swaps_p = float(rows_k[1].sum()), float(rows_p[1].sum())
    print(f"sweep n_beta={CHECK_NBETA}: accepted swaps kernel {swaps_k:.0f}, plain {swaps_p:.0f} of "
          f"{K // CHECK_NBETA * (CHECK_NBETA - 1)} proposed; flip acceptance kernel {float(rows_k[0].sum()) / (N * K):.4f}")
    if not 0 < swaps_k < K:
        failures.append(f"sweep n_beta={CHECK_NBETA}: {swaps_k:.0f} swaps accepted")

    # the megakernel against the sweep kernel + energy kernel, and its plain version
    mega = {}
    for nb in (1, CHECK_NBETA):
        us = u_swap if nb > 1 else None
        cm, lm, am, om = sweeps_offdiag_cuda(work, cache, sched, u, nb, us)
        c2, l2, a2 = sweep_cuda(work, cache, sched, u, nb, us)
        o2 = offdiag_sum_cuda(work, c2)
        share2, _, same2 = _compare(f"sweep_energy n_beta={nb} vs sweep+energy kernels", cm, lm, c2, l2,
                                    SWEEP_MISMATCH_MAX, SWEEP_Y_ATOL, SWEEP_LNPSI_ATOL, failures)
        rel2 = _rel(om, o2, same2)
        cp, lp, ap, op = sweeps_offdiag_plain(work, cache, lnpsi, sched, u, nb, us)
        share_p, ln_p, same_p = _compare(f"sweep_energy n_beta={nb} vs plain", cm, lm, cp, lp, SWEEP_MISMATCH_MAX,
                                         SWEEP_Y_ATOL, SWEEP_LNPSI_ATOL, failures)
        rel_p = _rel(om, op, same_p)
        print(f"sweep_energy n_beta={nb}: offdiag on agreeing walkers, relative to max: vs the two kernels {rel2:.3e}, "
              f"vs plain {rel_p:.3e} (tol {OFFDIAG_RTOL:.0e}); accepted {float(am):.0f} / {float(a2):.0f} / {float(ap):.0f}")
        if not (rel2 <= OFFDIAG_RTOL and rel_p <= OFFDIAG_RTOL):
            failures.append(f"sweep_energy n_beta={nb}: offdiag {rel2:.3e} / {rel_p:.3e}")
        mega[nb] = {"mismatch_vs_kernels": share2, "offdiag_rel_vs_kernels": rel2, "mismatch_share": share_p,
                    "max_abs_err": ln_p, "offdiag_rel_err": rel_p}

    # the exchange kernel at the Hubbard flagship's shapes: one sweep on the
    # kernel's Philox stream (the training paths' mode) and on caller
    # uniforms, and one launch of several sweeps on the stream
    hn, n_unit = 2 * HUB_L, hubbard.n_unit_steps
    hparams = {k: PARAM_SCALE * v for k, v in RBM(n_inputs=hn, n_hiddens=HUB_H).init_params(g).items()}
    hwork = RBM(n_inputs=hn, n_hiddens=HUB_H).make_work(hparams)
    hcache, hlnpsi = engine.full_forward(hwork, hubbard.init_spins(g, HUB_K))
    bonds = torch.as_tensor(hubbard.bonds, device=dev)
    u_sel, u_acc = uniform_block(g, (n_unit, HUB_K)), uniform_block(g, (n_unit, HUB_K))
    exchange_draws = ExchangeDraws(philox_key(g), n_unit)
    multi_draws = ExchangeDraws(philox_key(g), EXCHANGE_MULTI_SWEEPS * n_unit)
    staged_seen = set()  # (with c, W from shared memory) of each exchange comparison
    staged_seen_t = set()  # the same for the tempered instance

    def exchange_vs_plain(label, w_, c_, ln_, bonds_, uniforms, mismatch_max, cut, n_beta=1, swaps=None):
        """Kernel vs plain exchange rounds on the same uniforms (an
        ExchangeDraws, or the (u_sel, u_acc) pair; for n_beta > 1 the
        tempered instance against the plain tempered exchange, in sweeps of
        N proposals, with the (n_sweeps, 2, K) swap uniforms beside the
        pair); the sectors kept, per flavor half, in every walker row (the
        walkers start with the same particle numbers, so a row holds them
        whichever replica's configuration it ends with). Returns (share,
        ln_err, acceptance)."""
        args = (uniforms,) if isinstance(uniforms, ExchangeDraws) else uniforms
        k_, n_ = c_.spins.shape
        seen = staged_seen if n_beta == 1 else staged_seen_t
        seen.add((w_.c is not None, stages_w(n_, w_.w.shape[1], bonds_.shape[0], w_.c is not None, n_beta)))
        if n_beta > 1:
            kw = {"n_beta": n_beta, "n_unit": n_, "swap_uniforms": swaps}
            ck, lk, rows_k = exchange_cuda(w_, c_, bonds_, *args, **kw)
            cp, lp, rows_p = tempered_exchange_plain(w_, c_, ln_, bonds_, *args, **kw)
            acc_p = rows_p[0].sum()
        else:
            ck, lk, rows_k = exchange_cuda(w_, c_, bonds_, *args)
            cp, lp, acc_p = exchange_plain(w_, c_, ln_, bonds_, *args)
        acc_k = rows_k[0].sum()
        share_, ln_err_, _ = _compare(label, ck, lk, cp, lp, mismatch_max, EXCHANGE_Y_ATOL, EXCHANGE_LNPSI_ATOL,
                                      failures, cut=cut)
        n_steps = args[0].n_steps if isinstance(uniforms, ExchangeDraws) else args[0].shape[0]
        half = n_ // 2
        kept = all(bool(((ck.spins[:, sl] > 0).sum(1) == (c_.spins[:, sl] > 0).sum(1)).all())
                   for sl in (slice(0, half), slice(half, n_)))
        acc = float(acc_k) / (n_steps * k_)
        print(f"{label}: acceptance kernel {acc:.4f}, plain {float(acc_p) / (n_steps * k_):.4f}; sectors kept: {kept}")
        if not kept:
            failures.append(f"{label}: a walker row changed its particle numbers")
        if not 0.0 < acc < 1.0:
            failures.append(f"{label}: acceptance {acc}")
        if n_beta > 1:
            # each chain proposes its n_beta - 1 adjacent pairs once per sweep
            proposed = n_steps // n_ * (k_ // n_beta) * (n_beta - 1)
            swaps_k, swaps_p = float(rows_k[1].sum()), float(rows_p[1].sum())
            print(f"{label}: accepted swaps kernel {swaps_k:.0f}, plain {swaps_p:.0f} of {proposed} proposed")
            if not 0 < swaps_k < proposed:
                failures.append(f"{label}: {swaps_k:.0f} swaps accepted of {proposed}")
        return share_, ln_err_, acc

    x_share, x_ln_err, _ = exchange_vs_plain("exchange philox", hwork, hcache, hlnpsi, bonds, exchange_draws,
                                             EXCHANGE_MISMATCH_MAX, False)
    xu_share, xu_ln_err, _ = exchange_vs_plain("exchange", hwork, hcache, hlnpsi, bonds, (u_sel, u_acc),
                                               EXCHANGE_MISMATCH_MAX, False)
    xm_share, xm_ln_err, _ = exchange_vs_plain(f"exchange philox, {EXCHANGE_MULTI_SWEEPS} sweeps in one launch", hwork,
                                               hcache, hlnpsi, bonds, multi_draws, EXCHANGE_MISMATCH_MAX, False)
    xk, _, _ = exchange_cuda(hwork, hcache, bonds, exchange_draws)
    x_sector = sector_ok(xk.spins)
    print(f"exchange: {HUB_PARTICLES}+{HUB_PARTICLES} sectors kept: {x_sector}")
    if not x_sector:
        failures.append("exchange kernel: a walker left its particle sector")

    def ffnn_work(m):
        return m.make_work({k: torch.complex(v.real, PARAM_SCALE * v.imag) for k, v in m.init_params(g).items()})

    # the instances with output weights c: a plain FFNN, every c_j distinct
    fwork = ffnn_work(FFNN(n_inputs=N, n_hiddens=h, dtype=torch.float32))
    fcache, flnpsi = engine.full_forward(fwork, random_spins(g, K, N))
    ec_rel, ec_abs, ec_near = energy_vs_plain("energy with c", fwork, fcache, flnpsi, ENERGY_RTOL, SWEEP_MISMATCH_MAX)
    sweep_c = {}
    for nb in (1, CHECK_NBETA):
        us = u_swap if nb > 1 else None
        ck, lk, acc_k = sweep_cuda(fwork, fcache, sched, u, nb, us)
        cp, lp, acc_p = sweep_plain(fwork, fcache, flnpsi, sched, u, nb, us)
        sweep_c[nb] = _compare(f"sweep with c n_beta={nb}", ck, lk, cp, lp, SWEEP_MISMATCH_MAX, SWEEP_Y_ATOL,
                               SWEEP_LNPSI_ATOL, failures, cut=True)[:2]
        print(f"sweep with c n_beta={nb}: flip acceptance kernel {float(acc_k) / (N * K):.4f}, plain {float(acc_p) / (N * K):.4f}")
    hfwork = ffnn_work(FFNN(n_inputs=hn, n_hiddens=FFNN_HUB_H, dtype=torch.float32))
    hfcache, hflnpsi = engine.full_forward(hfwork, hubbard.init_spins(g, HUB_K))
    xc_share, xc_ln_err, _ = exchange_vs_plain("exchange with c philox", hfwork, hfcache, hflnpsi, bonds,
                                               exchange_draws, EXCHANGE_MISMATCH_MAX, True)
    xcu_share, xcu_ln_err, _ = exchange_vs_plain("exchange with c", hfwork, hfcache, hflnpsi, bonds, (u_sel, u_acc),
                                                 EXCHANGE_MISMATCH_MAX, True)
    xcm_share, xcm_ln_err, _ = exchange_vs_plain(f"exchange with c philox, {EXCHANGE_MULTI_SWEEPS} sweeps in one launch",
                                                 hfwork, hfcache, hflnpsi, bonds, multi_draws, EXCHANGE_MISMATCH_MAX, True)
    xk, _, _ = exchange_cuda(hfwork, hfcache, bonds, exchange_draws)
    if not sector_ok(xk.spins):
        failures.append("exchange kernel with c: a walker left its particle sector")

    # the tempered instance at the flagship's shapes: one sweep and its swap
    # phases on its Philox stream, on caller uniforms, and 5 sweeps in one
    # launch, at n_beta = 4 and 8, with and without c
    u_swap_x = uniform_block(g, (1, 2, HUB_K))
    tempered_x = {}
    for clab, w_, c_, ln_ in (("", hwork, hcache, hlnpsi), (" with c", hfwork, hfcache, hflnpsi)):
        for nb in (TEMPERED_NBETA, CHECK_NBETA):
            for mode, unif, sw in (("philox", exchange_draws, None), ("uniforms", (u_sel, u_acc), u_swap_x),
                                   ("multi", multi_draws, None)):
                label = f"exchange tempered{clab} n_beta={nb} " + {
                    "philox": "philox", "uniforms": "on caller uniforms",
                    "multi": f"philox, {EXCHANGE_MULTI_SWEEPS} sweeps in one launch"}[mode]
                tempered_x[(clab, nb, mode)] = exchange_vs_plain(label, w_, c_, ln_, bonds, unif,
                                                                 EXCHANGE_MISMATCH_MAX, bool(clab), nb, sw)[:2]
        xk, _, _ = exchange_cuda(w_, c_, bonds, multi_draws, n_beta=TEMPERED_NBETA, n_unit=n_unit)
        if not sector_ok(xk.spins):
            failures.append(f"exchange tempered{clab}: a replica left its particle sector")

    # no visible bias (the kernels read zeros for a): RBMSfSymm, alpha = 4
    smachine = RBMSfSymm(n_inputs=N, alpha=ALPHA, dtype=torch.float32)
    swork = smachine.make_work({k: PARAM_SCALE * v for k, v in smachine.init_params(g).items()})
    scache, slnpsi = engine.full_forward(swork, random_spins(g, K, N))
    energy_vs_plain("energy without a", swork, scache, slnpsi, ENERGY_RTOL, 0.0)
    ck, lk, _ = sweep_cuda(swork, scache, sched, u)
    cp, lp, _ = sweep_plain(swork, scache, slnpsi, sched, u)
    _compare("sweep without a", ck, lk, cp, lp, SWEEP_MISMATCH_MAX, SWEEP_Y_ATOL, SWEEP_LNPSI_ATOL, failures)

    # every kernel and instance at widths off the multiples of 32
    for wh in WIDTHS:
        wm = RBM(n_inputs=WIDTH_N, n_hiddens=wh)
        wwork = wm.make_work({k: PARAM_SCALE * v for k, v in wm.init_params(g).items()})
        wcache, wln = engine.full_forward(wwork, random_spins(g, WIDTH_K, WIDTH_N))
        wsched = torch.as_tensor(LITFIChain(n_sites=WIDTH_N).schedule())
        wu, wus = uniform_block(g, (WIDTH_N, WIDTH_K)), uniform_block(g, (1, 2, WIDTH_K))
        for nb in (1, TEMPERED_NBETA):
            wk, wlk, _ = sweep_cuda(wwork, wcache, wsched, wu, nb, wus if nb > 1 else None)
            wp, wlp, _ = sweep_plain(wwork, wcache, wln, wsched, wu, nb, wus if nb > 1 else None)
            _compare(f"H={wh} sweep n_beta={nb}", wk, wlk, wp, wlp, WIDTH_MISMATCH_MAX, SWEEP_Y_ATOL, SWEEP_LNPSI_ATOL,
                     failures)
        w_rel = _rel(offdiag_sum_cuda(wwork, wcache), offdiag_sum_plain(wwork, wcache, wln))
        cm, lm, _, om = sweeps_offdiag_cuda(wwork, wcache, wsched, wu)
        cp, lp, _, op = sweeps_offdiag_plain(wwork, wcache, wln, wsched, wu)
        _, _, wsame = _compare(f"H={wh} sweep_energy", cm, lm, cp, lp, WIDTH_MISMATCH_MAX, SWEEP_Y_ATOL, SWEEP_LNPSI_ATOL,
                               failures)
        wm_rel = _rel(om, op, wsame)
        wham = HubbardChain(n_sites=WIDTH_N, n_up=4, n_down=4)
        whc, whl = engine.full_forward(wwork, wham.init_spins(g, WIDTH_K))
        wb = torch.as_tensor(wham.bonds, device=dev)
        ws, wa = uniform_block(g, (WIDTH_N, WIDTH_K)), uniform_block(g, (WIDTH_N, WIDTH_K))
        wx = ExchangeDraws(philox_key(g), 2 * WIDTH_N)  # two sweeps in one launch
        exchange_vs_plain(f"H={wh} exchange", wwork, whc, whl, wb, (ws, wa), WIDTH_MISMATCH_MAX, False)
        exchange_vs_plain(f"H={wh} exchange philox", wwork, whc, whl, wb, wx, WIDTH_MISMATCH_MAX, False)
        wsw = uniform_block(g, (1, 2, WIDTH_K))
        exchange_vs_plain(f"H={wh} exchange tempered n_beta={TEMPERED_NBETA}", wwork, whc, whl, wb, (ws, wa),
                          WIDTH_MISMATCH_MAX, False, TEMPERED_NBETA, wsw)
        exchange_vs_plain(f"H={wh} exchange tempered philox n_beta={TEMPERED_NBETA}", wwork, whc, whl, wb, wx,
                          WIDTH_MISMATCH_MAX, False, TEMPERED_NBETA)
        print(f"H={wh}: energy relative error {w_rel:.3e}, sweep_energy offdiag {wm_rel:.3e} (tol {ENERGY_RTOL:.0e})")
        if not (w_rel <= ENERGY_RTOL and wm_rel <= ENERGY_RTOL):
            failures.append(f"H={wh}: energy {w_rel:.3e}, sweep_energy {wm_rel:.3e}")
        # the instances with c at this width
        wfwork = ffnn_work(FFNN(n_inputs=WIDTH_N, n_hiddens=wh, dtype=torch.float32))
        wfcache, wfln = engine.full_forward(wfwork, random_spins(g, WIDTH_K, WIDTH_N))
        for nb in (1, TEMPERED_NBETA):
            wk, wlk, _ = sweep_cuda(wfwork, wfcache, wsched, wu, nb, wus if nb > 1 else None)
            wp, wlp, _ = sweep_plain(wfwork, wfcache, wfln, wsched, wu, nb, wus if nb > 1 else None)
            _compare(f"H={wh} sweep with c n_beta={nb}", wk, wlk, wp, wlp, WIDTH_MISMATCH_MAX, SWEEP_Y_ATOL,
                     SWEEP_LNPSI_ATOL, failures, cut=True)
        energy_vs_plain(f"H={wh} energy with c", wfwork, wfcache, wfln, ENERGY_RTOL, WIDTH_MISMATCH_MAX)
        whc, whl = engine.full_forward(wfwork, wham.init_spins(g, WIDTH_K))
        exchange_vs_plain(f"H={wh} exchange with c", wfwork, whc, whl, wb, (ws, wa), WIDTH_MISMATCH_MAX, True)
        exchange_vs_plain(f"H={wh} exchange with c philox", wfwork, whc, whl, wb, wx, WIDTH_MISMATCH_MAX, True)
        exchange_vs_plain(f"H={wh} exchange tempered with c n_beta={TEMPERED_NBETA}", wfwork, whc, whl, wb, (ws, wa),
                          WIDTH_MISMATCH_MAX, True, TEMPERED_NBETA, wsw)
        exchange_vs_plain(f"H={wh} exchange tempered with c philox n_beta={TEMPERED_NBETA}", wfwork, whc, whl, wb, wx,
                          WIDTH_MISMATCH_MAX, True, TEMPERED_NBETA)

    # the Philox mode: the kernel draws its uniforms on the chip, the plain
    # sweep makes the same numbers (ops/rng.py philox_uniforms)
    philox = {}
    for label, w_, c_, ln_, cut in (("", work, cache, lnpsi, False), (" with c", fwork, fcache, flnpsi, True)):
        for nb in (1, CHECK_NBETA):
            draws = PhiloxDraws(philox_key(g), N)
            ck, lk, acc_k = sweep_cuda(w_, c_, sched, draws, nb)
            cp, lp, acc_p = sweep_plain(w_, c_, ln_, sched, draws, nb)
            philox[(label, nb)] = _compare(f"sweep{label} philox n_beta={nb}", ck, lk, cp, lp, SWEEP_MISMATCH_MAX,
                                           SWEEP_Y_ATOL, SWEEP_LNPSI_ATOL, failures, cut=cut)[:2]
            acc = float(acc_k) / (N * K)
            print(f"sweep{label} philox n_beta={nb}: flip acceptance kernel {acc:.4f}, plain {float(acc_p) / (N * K):.4f}")
            if not 0.0 < acc < 1.0:
                failures.append(f"sweep{label} philox n_beta={nb}: acceptance {acc}")
    for wh in WIDTHS:
        wsched = torch.as_tensor(LITFIChain(n_sites=WIDTH_N).schedule())
        for label, wm in (("", RBM(n_inputs=WIDTH_N, n_hiddens=wh)),
                          (" with c", FFNN(n_inputs=WIDTH_N, n_hiddens=wh, dtype=torch.float32))):
            wwork = ffnn_work(wm) if label else wm.make_work({k: PARAM_SCALE * v for k, v in wm.init_params(g).items()})
            wcache, wln = engine.full_forward(wwork, random_spins(g, WIDTH_K, WIDTH_N))
            for nb in (1, CHECK_NBETA):
                draws = PhiloxDraws(philox_key(g), WIDTH_N)
                wk, wlk, _ = sweep_cuda(wwork, wcache, wsched, draws, nb)
                wp, wlp, _ = sweep_plain(wwork, wcache, wln, wsched, draws, nb)
                _compare(f"H={wh} sweep{label} philox n_beta={nb}", wk, wlk, wp, wlp, WIDTH_MISMATCH_MAX, SWEEP_Y_ATOL,
                         SWEEP_LNPSI_ATOL, failures, cut=bool(label))
    # a sampler call's mode: MULTI_SWEEPS sweeps in one launch on one stream
    multi = {}
    multi_draws_sweep = PhiloxDraws(philox_key(g), MULTI_SWEEPS * N)
    for label, w_, c_, ln_, cut in (("", work, cache, lnpsi, False), (" with c", fwork, fcache, flnpsi, True)):
        for nb in (1, CHECK_NBETA):
            ck, lk, acc_k = sweep_cuda(w_, c_, sched, multi_draws_sweep, nb)
            cp, lp, acc_p = sweep_plain(w_, c_, ln_, sched, multi_draws_sweep, nb)
            multi[(label, nb)] = _compare(f"sweep{label} {MULTI_SWEEPS} sweeps in one launch n_beta={nb}", ck, lk, cp,
                                          lp, SWEEP_MISMATCH_MAX, SWEEP_Y_ATOL, SWEEP_LNPSI_ATOL, failures, cut=cut)[:2]
            print(f"sweep{label} {MULTI_SWEEPS} sweeps n_beta={nb}: flip acceptance kernel "
                  f"{float(acc_k) / (MULTI_SWEEPS * N * K):.4f}, plain {float(acc_p) / (MULTI_SWEEPS * N * K):.4f}")
    # the 2D schedules: the 8x8 square checkerboard and the 9x9 three-colour order
    two_d = {}
    for lab, ham2 in (("8x8 checkerboard", TFICheckerBoard(n_sites=TWO_D_L**2)), (f"{TRI_L}x{TRI_L} three-colour",
                                                                                   TFITRI(n_sites=TRI_L**2))):
        n2, s2 = ham2.n_sites, torch.as_tensor(ham2.schedule())
        for clab, m2 in (("", RBM(n_inputs=n2, n_hiddens=TWO_D_H)),
                         (" with c", FFNN(n_inputs=n2, n_hiddens=TWO_D_H, dtype=torch.float32))):
            w2 = ffnn_work(m2) if clab else m2.make_work({k: PARAM_SCALE * v for k, v in m2.init_params(g).items()})
            c2_, l2_ = engine.full_forward(w2, random_spins(g, TWO_D_K, n2))
            d2 = PhiloxDraws(philox_key(g), 2 * n2)
            ck, lk, _ = sweep_cuda(w2, c2_, s2, d2)
            cp, lp, _ = sweep_plain(w2, c2_, l2_, s2, d2)
            two_d[lab + clab] = _compare(f"sweep{clab} on the {lab} schedule, 2 sweeps", ck, lk, cp, lp,
                                         SWEEP_MISMATCH_MAX, SWEEP_Y_ATOL, SWEEP_LNPSI_ATOL, failures, cut=bool(clab))[:2]

    # the energy kernel's float64 instance against the plain float64 sum
    def widened(w_, c_):
        w64 = engine.Work(*(None if t is None else t.to(torch.complex128) for t in w_))
        return (w64, *engine.full_forward(w64, c_.spins.double()))

    f64_cases = {"": widened(work, cache), " with c": widened(fwork, fcache)}
    f64_err = {}
    for label, (w64, c64, l64) in f64_cases.items():
        got, want = offdiag_sum_cuda(w64, c64), offdiag_sum_plain(w64, c64, l64)
        f64_err[label] = (_rel(got, want), float((got - want).abs().max()))
    for wh in WIDTHS:
        for label, wm in (("", RBM(n_inputs=WIDTH_N, n_hiddens=wh)),
                          (" with c", FFNN(n_inputs=WIDTH_N, n_hiddens=wh, dtype=torch.float32))):
            wwork = ffnn_work(wm) if label else wm.make_work({k: PARAM_SCALE * v for k, v in wm.init_params(g).items()})
            w64, c64, l64 = widened(wwork, engine.full_forward(wwork, random_spins(g, WIDTH_K, WIDTH_N))[0])
            f64_err[f" H={wh}{label}"] = (_rel(offdiag_sum_cuda(w64, c64), offdiag_sum_plain(w64, c64, l64)), None)
    for label, (rel, _) in f64_err.items():
        print(f"energy float64{label}: max|kernel-plain| / max|plain| {rel:.3e} (tol {F64_ENERGY_RTOL:.0e})")
        if not rel <= F64_ENERGY_RTOL:
            failures.append(f"energy float64{label}: relative error {rel:.3e}")

    # the hot-math chain-rate probe against its plain chain at bench.py's size
    cx, cy = probe_inputs(N_ELEMS, dev)
    chain_err = {}
    for body in BODIES:
        kx, ky = chain_cuda(body, cx, cy)
        px, py = chain_plain(body, cx, cy)
        far = ~chain_near_cut(body, cx, cy)
        got, want = torch.stack([kx, ky]), torch.stack([px, py])
        finite = bool(torch.isfinite(got).all())
        abs_err = float((got - want)[:, far].abs().max())
        rel = abs_err / float(want.abs().max())
        near_share = 1.0 - float(far.double().mean())
        chain_err[body] = {"max_abs_err": abs_err, "rel_err": rel, "near_cut_share": near_share,
                           "rel_err_all": float((got - want).abs().max() / want.abs().max())}
        print(f"chain_rate {body}: max|kernel-plain| {abs_err:.3e}, relative to max|plain| {rel:.3e} (tol "
              f"{CHAIN_RTOL:.0e}) away from the cut; near the cut {near_share:.2e} (max {CHAIN_NEAR_CUT_MAX:.0e}); "
              f"over all elements {chain_err[body]['rel_err_all']:.3e}; finite {finite}")
        if not (finite and rel <= CHAIN_RTOL and near_share <= CHAIN_NEAR_CUT_MAX):
            failures.append(f"chain_rate {body}: relative error {rel:.3e}, near-cut share {near_share:.2e}")

    philox_draws = PhiloxDraws(philox_key(g), N)
    print(f"exchange: (with c, W from shared memory) over the comparisons: {sorted(staged_seen)}; "
          f"tempered: {sorted(staged_seen_t)}")
    if len(staged_seen) != 4 or len(staged_seen_t) != 4:
        failures.append(f"exchange: the comparisons missed a W branch: ran {sorted(staged_seen)}, "
                        f"tempered {sorted(staged_seen_t)}")

    calls = {  # (wrapper, plain version) on the same inputs at the main paths' shapes, in their draw mode
        "sweep": (lambda: sweep_cuda(work, cache, sched, philox_draws),
                  lambda: sweep_plain(work, cache, lnpsi, sched, philox_draws)),
        "energy": (lambda: offdiag_sum_cuda(work, cache), lambda: offdiag_sum_plain(work, cache, lnpsi)),
        "exchange": (lambda: exchange_cuda(hwork, hcache, bonds, exchange_draws),
                     lambda: exchange_plain(hwork, hcache, hlnpsi, bonds, exchange_draws)),
        "sweep_energy": (lambda: sweeps_offdiag_cuda(work, cache, sched, u),
                         lambda: sweeps_offdiag_plain(work, cache, lnpsi, sched, u)),
        # the instances with output weights c, on the FFNN inputs of the same shapes
        "sweep_c": (lambda: sweep_cuda(fwork, fcache, sched, philox_draws),
                    lambda: sweep_plain(fwork, fcache, flnpsi, sched, philox_draws)),
        "energy_c": (lambda: offdiag_sum_cuda(fwork, fcache), lambda: offdiag_sum_plain(fwork, fcache, flnpsi)),
        "exchange_c": (lambda: exchange_cuda(hfwork, hfcache, bonds, exchange_draws),
                       lambda: exchange_plain(hfwork, hfcache, hflnpsi, bonds, exchange_draws)),
        # the exchange kernel's tempered instance at the escalation's ladder
        "exchange_tempered": (lambda: exchange_cuda(hwork, hcache, bonds, exchange_draws, n_beta=TEMPERED_NBETA,
                                                    n_unit=n_unit),
                              lambda: tempered_exchange_plain(hwork, hcache, hlnpsi, bonds, exchange_draws, None,
                                                              TEMPERED_NBETA, n_unit)),
        "exchange_tempered_c": (lambda: exchange_cuda(hfwork, hfcache, bonds, exchange_draws, n_beta=TEMPERED_NBETA,
                                                      n_unit=n_unit),
                                lambda: tempered_exchange_plain(hfwork, hfcache, hflnpsi, bonds, exchange_draws, None,
                                                                TEMPERED_NBETA, n_unit)),
        # the chain-rate probe at bench.py's size, each body
        "chain_rate": (lambda: chain_cuda("sweep", cx, cy), lambda: chain_plain("sweep", cx, cy)),
        "chain_rate_energy": (lambda: chain_cuda("energy", cx, cy), lambda: chain_plain("energy", cx, cy)),
        # the energy kernel's float64 instance on the widened inputs of the same shapes
        "energy_f64": (lambda: offdiag_sum_cuda(*f64_cases[""][:2]), lambda: offdiag_sum_plain(*f64_cases[""])),
        "energy_f64_c": (lambda: offdiag_sum_cuda(*f64_cases[" with c"][:2]),
                         lambda: offdiag_sum_plain(*f64_cases[" with c"])),
    }
    multi_calls = {  # the sweep as a sampler call runs it: MULTI_SWEEPS sweeps in one launch
        "sweep": lambda: sweep_cuda(work, cache, sched, multi_draws_sweep),
        "sweep_c": lambda: sweep_cuda(fwork, fcache, sched, multi_draws_sweep),
    }
    uniform_calls = {  # the sweep and exchange on caller uniforms, as the tests (and the A/B) feed them
        "sweep": lambda: sweep_cuda(work, cache, sched, u),
        "sweep_c": lambda: sweep_cuda(fwork, fcache, sched, u),
        "exchange": lambda: exchange_cuda(hwork, hcache, bonds, u_sel, u_acc),
        "exchange_c": lambda: exchange_cuda(hfwork, hfcache, bonds, u_sel, u_acc),
        "exchange_tempered": lambda: exchange_cuda(hwork, hcache, bonds, u_sel, u_acc, n_beta=TEMPERED_NBETA,
                                                   n_unit=n_unit, swap_uniforms=u_swap_x),
        "exchange_tempered_c": lambda: exchange_cuda(hfwork, hfcache, bonds, u_sel, u_acc, n_beta=TEMPERED_NBETA,
                                                     n_unit=n_unit, swap_uniforms=u_swap_x),
    }
    tempered_philox = PhiloxDraws(philox_key(g), N)
    tempered_calls = {  # the sweep as the tempered path draws, the megakernel as the A/B does
        "sweep": lambda: sweep_cuda(work, cache, sched, tempered_philox, CHECK_NBETA),
        "sweep_energy": lambda: sweeps_offdiag_cuda(work, cache, sched, u, CHECK_NBETA, u_swap),
        "sweep_c": lambda: sweep_cuda(fwork, fcache, sched, tempered_philox, CHECK_NBETA),
        "exchange_tempered": lambda: exchange_cuda(hwork, hcache, bonds, exchange_draws, n_beta=CHECK_NBETA,
                                                   n_unit=n_unit),
        "exchange_tempered_c": lambda: exchange_cuda(hfwork, hfcache, bonds, exchange_draws, n_beta=CHECK_NBETA,
                                                     n_unit=n_unit),
    }
    timing = {name: (_time_ms(torch, fn, 20), _time_ms(torch, plain, 2)) for name, (fn, plain) in calls.items()}
    tempered_ms = {name: _time_ms(torch, fn, 20) for name, fn in tempered_calls.items()}
    uniform_ms = {name: _time_ms(torch, fn, 20) for name, fn in uniform_calls.items()}
    sweep_multi_ms = {name: _time_ms(torch, fn, 10) for name, fn in multi_calls.items()}
    for name, (w_ms, p_ms) in timing.items():
        print(f"{name}: wrapper {w_ms:.4f} ms, plain {p_ms:.3f} ms per call (CUDA events; a sweep or exchange call is one sweep)")
    for body, name in zip(BODIES, ("chain_rate", "chain_rate_energy")):
        print(f"chain_rate {body}: {N_ELEMS * CHAIN_LEN / (timing[name][0] / 1e3):.4e} elements/s (wrapper time)")
    for name, w_ms in tempered_ms.items():
        print(f"{name} n_beta={CHECK_NBETA}: wrapper {w_ms:.4f} ms per call (one sweep and its swap phases)")
    for name, w_ms in uniform_ms.items():
        print(f"{name} on caller uniforms: wrapper {w_ms:.4f} ms per call")
    for name, w_ms in sweep_multi_ms.items():
        print(f"{name} {MULTI_SWEEPS} sweeps in one launch: wrapper {w_ms:.4f} ms per call")
    _require(not failures, "; ".join(failures))
    c64, f32b, i32b = 8, 4, 4
    # the state in and out, the weights, the counts; the sweep reads a 16-byte
    # Philox key (the main paths' mode), the megakernel the (N, K) uniforms
    sweep_bytes = (2 * K * h * c64 + 2 * K * N * f32b + 2 * K * c64 + N * h * c64 + N * c64 + 2 * K * i32b + 16)
    uniform_bytes = N * K * f32b
    energy_bytes = K * h * c64 + K * N * f32b + N * h * c64 + N * c64 + K * c64
    sweep_bound = _bound_ms(K * N * h * SWEEP_OPS, sweep_bytes)
    energy_bound = _bound_ms(K * N * h * ENERGY_OPS, energy_bytes)
    # the instances with c: their operations, and c read once
    sweep_c_bound = _bound_ms(K * N * h * SWEEP_OPS_C, sweep_bytes + h * c64)
    energy_c_bound = _bound_ms(K * N * h * ENERGY_OPS_C, energy_bytes + h * c64)
    # the megakernel: the two kernels' operations; its bytes are the sweep's,
    # the uniforms, and the off-diagonal sum's output (the state is read and
    # written once)
    sweep_energy_bound = _bound_ms(K * N * h * (SWEEP_OPS + ENERGY_OPS), sweep_bytes + uniform_bytes + K * c64)
    # the other modes: caller uniforms in place of the key; n_beta = 8 adds the
    # two swap phases of each walker row (the swap uniforms come from the key,
    # or for the megakernel a (1, 2, K) block)
    swap_ops = 2 * K * SWAP_OPS
    sweep_u_bound = _bound_ms(K * N * h * SWEEP_OPS, sweep_bytes - 16 + uniform_bytes)
    sweep_t_bound = _bound_ms(K * N * h * SWEEP_OPS + swap_ops, sweep_bytes)
    sweep_c_u_bound = _bound_ms(K * N * h * SWEEP_OPS_C, sweep_bytes - 16 + uniform_bytes + h * c64)
    sweep_c_t_bound = _bound_ms(K * N * h * SWEEP_OPS_C + swap_ops, sweep_bytes + h * c64)
    sweep_energy_t_bound = _bound_ms(K * N * h * (SWEEP_OPS + ENERGY_OPS) + swap_ops,
                                     sweep_bytes + uniform_bytes + 2 * K * f32b + K * c64)
    # a sampler call of MULTI_SWEEPS sweeps: their operations, the state moved once
    sweep_m_bound = _bound_ms(MULTI_SWEEPS * K * N * h * SWEEP_OPS, sweep_bytes)
    sweep_c_m_bound = _bound_ms(MULTI_SWEEPS * K * N * h * SWEEP_OPS_C, sweep_bytes + h * c64)
    # the energy kernel's float64 instance: the float32 instance's operations
    # at the float64 rate; y, a, c and the output in complex128, the spins in
    # float64, its (N, H, 4) float64 table
    c128, f64b = 16, 8

    def f64_bound(ops_per):
        ops = K * N * h * ops_per
        nbytes = K * h * c128 + K * N * f64b + N * h * 4 * f64b + N * c128 + K * c128 + (h * c128 if ops_per == ENERGY_OPS_C else 0)
        t_ops, t_bytes = ops / PEAK_F64_FLOPS, nbytes / PEAK_BYTES_S
        return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"

    energy_f64_bound, energy_f64_c_bound = f64_bound(ENERGY_OPS), f64_bound(ENERGY_OPS_C)
    # the exchange: the state in and out, the weights, the bonds and their
    # incidence table, the counts, and the 16-byte key (the training paths'
    # mode) or the two (n_unit, K) uniform blocks
    n_bonds = bonds.shape[0]

    def exchange_bytes(hh, uniforms):
        return (2 * HUB_K * hh * c64 + 2 * HUB_K * hn * f32b + 2 * HUB_K * c64 + hn * hh * c64 + hn * c64
                + 2 * n_bonds * i32b + (hn + 1 + 2 * n_bonds) * i32b + HUB_K * i32b
                + (2 * n_unit * HUB_K * f32b if uniforms else 16))

    exchange_ops = HUB_K * n_unit * (HUB_H * EXCHANGE_OPS_HIDDEN + n_bonds * EXCHANGE_OPS_BOND)
    exchange_c_ops = HUB_K * n_unit * (FFNN_HUB_H * EXCHANGE_OPS_HIDDEN_C + n_bonds * EXCHANGE_OPS_BOND)
    exchange_bound = _bound_ms(exchange_ops, exchange_bytes(HUB_H, False))
    exchange_u_bound = _bound_ms(exchange_ops, exchange_bytes(HUB_H, True))
    exchange_c_bound = _bound_ms(exchange_c_ops, exchange_bytes(FFNN_HUB_H, False) + FFNN_HUB_H * c64)
    exchange_c_u_bound = _bound_ms(exchange_c_ops, exchange_bytes(FFNN_HUB_H, True) + FFNN_HUB_H * c64)
    # one launch of EXCHANGE_MULTI_SWEEPS sweeps: their operations, the state moved once
    exchange_m_bound = _bound_ms(EXCHANGE_MULTI_SWEEPS * exchange_ops, exchange_bytes(HUB_H, False))
    exchange_c_m_bound = _bound_ms(EXCHANGE_MULTI_SWEEPS * exchange_c_ops,
                                   exchange_bytes(FFNN_HUB_H, False) + FFNN_HUB_H * c64)

    def drive(label, make_vmc, n_warm, n_steps, drift_tol):
        """Run one configuration through VMC.init, warm_up and run with the
        counts set to 0 just before; print times and memory, and the
        launches of the warm-up and of the steps apart (``warm_launches``);
        return what the checks need."""
        reset_counts()
        mem_base = torch.cuda.memory_allocated()  # what earlier phases still hold
        torch.cuda.reset_peak_memory_stats()
        t_main = time.perf_counter()
        vmc = make_vmc()
        params, state = vmc.init()
        warm = vmc.warm_up(params, state, n_warm)
        torch.cuda.synchronize()
        t_warm = time.perf_counter() - t_main
        warm_launches[label] = read_counts()[0]
        peak_warm = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fresh, _ = engine.full_forward(vmc.machine.make_work(params), warm.cache.spins)
        drift = float((fresh.y - warm.cache.y).abs().max())
        stamps = [time.perf_counter()]
        params, state, history, _ = vmc.run(params, warm, n_steps, callback=lambda i, st: stamps.append(time.perf_counter()))
        torch.cuda.synchronize()
        launches, plain_calls = read_counts()
        steps_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
        energies = [r["energy"] for r in history]
        print(f"{label}: init + warm-up ({n_warm} sweeps): {t_warm:.3f} s; y drift vs fresh forward {drift:.3e} (tol {drift_tol:.0e})")
        print(f"{label}: SR steps: {len(history)}; step ms first {steps_ms[0]:.2f}, mean of the rest "
              f"{sum(steps_ms[1:]) / max(1, len(steps_ms) - 1):.2f}; cg iters {[r['cg_iters'] for r in history[-3:]]}; "
              f"acceptance {history[-1]['acceptance']:.4f}")
        print(f"{label}: peak memory above the {mem_base / 2**20:.1f} MiB held before: init + warm-up "
              f"{(peak_warm - mem_base) / 2**20:.1f} MiB, SR steps {(torch.cuda.max_memory_allocated() - mem_base) / 2**20:.1f} MiB; "
              f"last energies {energies[-3:]}")
        steps_launches = {name: n - warm_launches[label][name] for name, n in launches.items()}
        print(f"{label}: launches {launches}: init + warm-up {warm_launches[label]}, SR steps {steps_launches}; "
              f"plain-version calls: {plain_calls}")
        _require(len(history) == n_steps and all(math.isfinite(e) for e in energies), f"{label}: energies {energies}")
        _require(drift <= drift_tol, f"{label}: cache drift {drift:.3e} after the warm-up")
        _require(plain_calls == 0, f"{label}: the main path called a plain version {plain_calls} times")
        return vmc, params, state, warm, launches

    path_launches, warm_launches = {}, {}
    _enter("4 LITFI flagship SR steps", t0)
    vmc, params, state, _, launches = drive(
        "LITFI",
        lambda: VMC(
            RBMTrSymm(n_inputs=N, alpha=ALPHA, dtype=torch.float32),
            LITFIChain(n_sites=N, h=-0.5, j=0.866, alpha=2.5, pbc=True),
            VMCConfig(n_walkers=K, learning_rate=1e-2, solver="cg", use_fused_sweeps=True, seed=3),
        ),
        WARM_SWEEPS, SR_STEPS, CACHE_ATOL,
    )
    _require(launches == expect(sweep=1 + SR_STEPS, energy=SR_STEPS) and warm_launches["LITFI"]["sweep"] == 1,
             f"launches {launches}: expected one sweep launch per sampler call (the warm-up's {WARM_SWEEPS} sweeps, "
             "each step's sweep) and one energy launch per step")
    path_launches["LITFI"] = launches

    _enter("5 Hubbard flagship SR steps", t0)
    hub_vmc, hub_params, hub_state, hub_warm, hub_launches = drive(
        "Hubbard",
        lambda: VMC(
            RBM(n_inputs=2 * HUB_L, n_hiddens=HUB_H, dtype=torch.float32),
            hubbard,
            VMCConfig(n_walkers=HUB_K, learning_rate=1e-2, solver="cg", use_fused_sweeps=True, seed=11),
        ),
        HUB_WARM_SWEEPS, HUB_SR_STEPS, CACHE_ATOL,
    )
    _require(hub_launches == expect(exchange=1 + HUB_SR_STEPS) and warm_launches["Hubbard"]["exchange"] == 1,
             f"Hubbard launches {hub_launches}: expected one exchange launch per sampler call (the warm-up's "
             f"{HUB_WARM_SWEEPS} sweeps, each step's sweep) and nothing else")
    _require(sector_ok(hub_warm.cache.spins) and sector_ok(hub_state.cache.spins),
             f"Hubbard: a walker left the {HUB_PARTICLES}+{HUB_PARTICLES} sector")
    print(f"Hubbard: every walker holds {HUB_PARTICLES} up and {HUB_PARTICLES} down particles after the warm-up and the steps")
    path_launches["Hubbard"] = hub_launches

    _enter("6 tempered LITFI flagship SR steps", t0)
    _, _, pt_state, _, pt_launches = drive(
        f"tempered LITFI (n_beta={TEMPERED_NBETA})",
        lambda: VMC(
            RBMTrSymm(n_inputs=N, alpha=ALPHA, dtype=torch.float32),
            LITFIChain(n_sites=N, h=-0.5, j=0.866, alpha=2.5, pbc=True),
            VMCConfig(n_walkers=K, learning_rate=1e-2, solver="cg", use_fused_sweeps=True, n_beta=TEMPERED_NBETA, seed=5),
        ),
        WARM_SWEEPS, SR_STEPS, CACHE_ATOL,
    )
    _require(pt_launches == expect(sweep=1 + SR_STEPS, energy=SR_STEPS),
             f"tempered launches {pt_launches}: expected one sweep launch per sampler call (the ladder in the "
             "kernel) and one energy launch per step")
    _require(tuple(pt_state.cache.spins.shape) == (K, N), f"tempered state {tuple(pt_state.cache.spins.shape)}")
    path_launches["tempered LITFI"] = pt_launches

    _enter("7 FFNN flagship SR steps", t0)
    ffnn_vmc, ffnn_params, ffnn_state, _, ffnn_launches = drive(
        "FFNN LITFI",
        lambda: VMC(
            FFNNTrSymm(n_inputs=N, alpha=ALPHA, dtype=torch.float32),
            LITFIChain(n_sites=N, h=-0.5, j=0.866, alpha=2.5, pbc=True),
            VMCConfig(n_walkers=K, learning_rate=1e-2, solver="cg", use_fused_sweeps=True, seed=3),
        ),
        WARM_SWEEPS, SR_STEPS, CACHE_ATOL,
    )
    _require(ffnn_launches == expect(sweep=1 + SR_STEPS, energy=SR_STEPS),
             f"FFNN launches {ffnn_launches}: expected one sweep launch per sampler call and one energy launch per step")
    path_launches["FFNN LITFI"] = ffnn_launches

    _enter("8 FFNN Hubbard SR steps", t0)
    _, _, fh_state, fh_warm, fh_launches = drive(
        "FFNN Hubbard",
        lambda: VMC(
            FFNN(n_inputs=2 * HUB_L, n_hiddens=FFNN_HUB_H, dtype=torch.float32),
            hubbard,
            VMCConfig(n_walkers=HUB_K, learning_rate=1e-2, solver="cg", use_fused_sweeps=True, seed=11),
        ),
        FFNN_HUB_WARM_SWEEPS, FFNN_HUB_SR_STEPS, CACHE_ATOL,
    )
    _require(fh_launches == expect(exchange=1 + FFNN_HUB_SR_STEPS) and warm_launches["FFNN Hubbard"]["exchange"] == 1,
             f"FFNN Hubbard launches {fh_launches}: expected one exchange launch per sampler call and nothing else")
    _require(sector_ok(fh_warm.cache.spins) and sector_ok(fh_state.cache.spins),
             f"FFNN Hubbard: a walker left the {HUB_PARTICLES}+{HUB_PARTICLES} sector")
    print(f"FFNN Hubbard: every walker holds {HUB_PARTICLES} up and {HUB_PARTICLES} down particles after the warm-up "
          "and the steps")
    path_launches["FFNN Hubbard"] = fh_launches

    _enter("9 solver cross-check", t0)
    # one (O, E) of the warmed LITFI flagship in float64 (solve_dtype), at
    # the first step's lambda and at the floor: lu, cholesky, svd, CG and
    # MINRES-QLP on the same system S + lam diag S against its LU solve;
    # sr_dense_solve's three solvers against each other (they add
    # _regularize_dense's 1e-7 max ridge, which moves the solution by more
    # than the bar: "ridge_shift"); minSR against the dense solve at its ridge
    check_vmc = VMC(vmc.machine, vmc.hamiltonian, VMCConfig(n_walkers=K, solve_dtype=torch.float64, seed=3), device=dev)
    e64, o64 = check_vmc.estimator_terms(params, state.cache, state.lnpsi)
    f_vec, a_o = force_vector(o64, e64)
    s_mat = build_s_matrix(o64, a_o)

    def rel_vec(a, b):
        return float((a - b).abs().norm() / b.abs().norm())

    solver_check, gated = {}, {}
    for lam in (lambda_schedule(0), LAMBDA_MIN):
        a_mat = s_mat + torch.diag_embed(lam * torch.diagonal(s_mat).real).to(s_mat.dtype)
        x_ref = solvers.lu_solve(a_mat, f_vec)
        cond = float(torch.linalg.cond(a_mat))
        dense = {name: sr_dense_solve(o64, e64, lam, solvers.SOLVERS[name]) for name in ("lu", "cholesky", "svd")}
        x_minsr, lam_abs = sr_minsr_solve(o64, e64, lam)
        x_abs = solvers.lu_solve(s_mat + float(lam_abs) * torch.eye(s_mat.shape[0], dtype=s_mat.dtype, device=dev), f_vec)
        row = {"cond": cond, "cholesky_vs_lu": rel_vec(solvers.cholesky_solve(a_mat, f_vec), x_ref),
               "svd_vs_lu": rel_vec(solvers.svd_lstsq(a_mat, f_vec), x_ref),
               "dense_cholesky_vs_lu": rel_vec(dense["cholesky"], dense["lu"]),
               "dense_svd_vs_lu": rel_vec(dense["svd"], dense["lu"]),
               "minsr_vs_dense_at_its_ridge": rel_vec(x_minsr, x_abs), "ridge_shift": rel_vec(dense["lu"], x_ref)}
        floor = lam == LAMBDA_MIN
        for tol in SOLVER_CHECK_TOLS if floor else SOLVER_CHECK_TOLS[:1]:
            for name, solve in (("cg", sr_cg_solve), ("minresqlp", sr_minres_solve)):
                x, res = solve(o64, e64, lam, tol=tol, max_iters=SOLVER_CHECK_MAX_ITERS)
                err = rel_vec(x, x_ref)
                # the forward error its relative residual allows: cond(A) ||A x - f|| / ||f||
                allowed = cond * rel_vec(a_mat @ x, f_vec)
                row[f"{name}_tol{tol:.0e}"] = {"vs_lu": err, "iterations": res.iterations, "cond_x_residual": allowed}
                bar = allowed if floor and tol == SOLVER_CHECK_TOLS[0] else SOLVER_CHECK_RTOL
                gated[f"lambda {lam:g} {name} tol {tol:.0e}"] = (err, bar)
        for key in ("cholesky_vs_lu", "svd_vs_lu", "dense_cholesky_vs_lu", "dense_svd_vs_lu", "minsr_vs_dense_at_its_ridge"):
            gated[f"lambda {lam:g} {key}"] = (row[key], SOLVER_CHECK_RTOL)
        solver_check[f"lambda {lam:g}"] = row
    print(f"solver cross-check (K={K}, V={o64.shape[1]}, complex128): {json.dumps(solver_check)} "
          f"(bar {SOLVER_CHECK_RTOL:.0e})")
    _require(all(err <= bar for err, bar in gated.values()),
             f"solver cross-check: {({k: v for k, v in gated.items() if not v[0] <= v[1]})}")
    del o64, e64, s_mat, a_mat, check_vmc

    _enter("10 solvers and modes, 10 SR steps each", t0)
    modes = {  # label: (machine, the change to the flagship's configuration)
        "lu": (RBMTrSymm, {"solver": "lu"}), "cholesky": (RBMTrSymm, {"solver": "cholesky"}),
        "svd": (RBMTrSymm, {"solver": "svd"}), "minsr": (RBMTrSymm, {"solver": "minsr"}),
        "sgd": (RBMTrSymm, {"solver": "sgd"}), "minresqlp": (RBMTrSymm, {"solver": "minresqlp"}),
        "auto": (RBMTrSymm, {"solver": "auto"}),
        # CG capped at 2 iterations ends unconverged: auto's MINRES-QLP fallback runs
        "auto, CG capped": (RBMTrSymm, {"solver": "auto", "cg_max_iters": AUTO_FORCED_CAP}),
        "cholesky, 3 rounds": (RBMTrSymm, {"solver": "cholesky", "n_accumulations": 3}),
        "cg, precond_ema 0.9": (RBMTrSymm, {"precond_ema": 0.9}),
        "energy_dtype float64": (RBMTrSymm, {"energy_dtype": torch.float64}),
        # the float64 energy instance with c, on a main path
        "FFNN energy_dtype float64": (FFNNTrSymm, {"energy_dtype": torch.float64}),
        "energy_dtype compensated": (RBMTrSymm, {"energy_dtype": "compensated"}),
        "block moves": (RBMTrSymm, {"block_moves_per_sweep": 1}),
    }
    auto_fallbacks = {}
    for label, (machine_cls, change) in modes.items():
        rounds = change.get("n_accumulations", 1)
        mvmc, _, _, _, m_launches = drive(
            f"LITFI {label}",
            lambda machine_cls=machine_cls, change=change: VMC(
                machine_cls(n_inputs=N, alpha=ALPHA, dtype=torch.float32),
                LITFIChain(n_sites=N, h=-0.5, j=0.866, alpha=2.5, pbc=True),
                VMCConfig(n_walkers=K, learning_rate=1e-2, use_fused_sweeps=True, seed=3,
                          **({"solver": "cg"} | change)),
                device=dev,
            ),
            WARM_SWEEPS, SOLVER_STEPS, CACHE_ATOL,
        )
        f64 = SOLVER_STEPS if change.get("energy_dtype") == torch.float64 else 0
        want = expect(sweep=1 + SOLVER_STEPS * rounds,
                      energy=0 if "energy_dtype" in change else SOLVER_STEPS * rounds,
                      energy_f64=f64, energy_f64_c=f64 if machine_cls is FFNNTrSymm else 0)
        _require(m_launches == want, f"LITFI {label}: launches {m_launches}, expected {want}")
        if change.get("solver") == "auto":
            auto_fallbacks[label] = mvmc.n_qlp_fallbacks
            print(f"LITFI {label}: MINRES-QLP fallbacks {mvmc.n_qlp_fallbacks} in {SOLVER_STEPS} steps")
        path_launches[f"LITFI {label}"] = m_launches
    _require(auto_fallbacks["auto, CG capped"] > 0,
             f"auto with CG capped at {AUTO_FORCED_CAP} iterations never fell back to MINRES-QLP: {auto_fallbacks}")

    _enter("11 Hubbard minSR SR steps", t0)
    ms_vmc, ms_params, ms_state, ms_warm, ms_launches = drive(
        "Hubbard minSR",
        lambda: VMC(
            RBM(n_inputs=2 * HUB_L, n_hiddens=HUB_H, dtype=torch.float32),
            hubbard,
            VMCConfig(n_walkers=HUB_K, learning_rate=1e-2, solver="minsr", use_fused_sweeps=True,
                      steps_per_host_loop=5, seed=11),
            device=dev,
        ),
        HUB_WARM_SWEEPS, HUB_SR_STEPS, CACHE_ATOL,
    )
    _require(ms_vmc.config.solve_dtype is None, "Hubbard minSR: the solve must stay float32, as in JAX")
    _require(ms_launches == expect(exchange=1 + HUB_SR_STEPS) and warm_launches["Hubbard minSR"]["exchange"] == 1,
             f"Hubbard minSR launches {ms_launches}: expected one exchange launch per sampler call")
    _require(sector_ok(ms_warm.cache.spins) and sector_ok(ms_state.cache.spins),
             f"Hubbard minSR: a walker left the {HUB_PARTICLES}+{HUB_PARTICLES} sector")
    print(f"Hubbard minSR: every walker holds {HUB_PARTICLES} up and {HUB_PARTICLES} down particles; float32 solve")
    path_launches["Hubbard minSR"] = ms_launches

    _enter("12 2D dense SR steps", t0)
    cb = TFICheckerBoard(n_sites=TWO_D_L**2, h=-1.5, j1=-1.0, j2=0.3, pbc=True)
    cb_vmc, cb_params, cb_state, _, cb_launches = drive(
        "2D checkerboard lu",
        lambda: VMC(
            FFNN(n_inputs=cb.n_sites, n_hiddens=TWO_D_H, dtype=torch.float32),
            cb,
            VMCConfig(n_walkers=TWO_D_K, learning_rate=1e-2, solver="lu", n_accumulations=TWO_D_ROUNDS, seed=3),
            device=dev,
        ),
        TWO_D_WARM, TWO_D_STEPS, CACHE_ATOL,
    )
    _require(cb_launches == expect(sweep=1 + TWO_D_STEPS * TWO_D_ROUNDS, energy=TWO_D_STEPS * TWO_D_ROUNDS),
             f"2D launches {cb_launches}: expected one sweep launch per sampler call, one energy launch per round")
    path_launches["2D checkerboard"] = cb_launches

    _enter("13 megakernel A/B", t0)
    reset_counts()
    ab = {nb: megakernel_ab.run_ab(nb) for nb in (1, CHECK_NBETA)}
    ab_launches, ab_plain = read_counts()
    for nb, r in ab.items():
        print(f"A/B n_beta={nb}: two kernels {r['two_kernel_ms']:.4f} ms, megakernel {r['megakernel_ms']:.4f} ms per "
              f"(sweep + offdiag) (runs {r['two_kernel_runs_ms']} / {r['megakernel_runs_ms']}), speed-up {r['speedup']:.3f}; "
              f"cross-check: other decisions {r['mismatch_share']:.2e}, offdiag {r['offdiag_rel_err']:.3e}, "
              f"y {r['y_max_abs_err']:.3e}")
        _require(r["mismatch_share"] <= SWEEP_MISMATCH_MAX and r["offdiag_rel_err"] <= OFFDIAG_RTOL,
                 f"A/B n_beta={nb}: arms disagree: {r}")
    print(f"A/B: launches {ab_launches}; plain-version calls: {ab_plain}")
    _require(ab_plain == 0 and ab_launches["sweep_energy"] > 0, f"A/B launches {ab_launches}, plain calls {ab_plain}")
    path_launches["megakernel A/B"] = ab_launches

    _enter("14 tempered Hubbard SR steps", t0)
    # n_beta = 4 (the collapse escalation's default ladder): tempered exchange,
    # which refuses use_fused_sweeps as in JAX
    th_label = f"tempered Hubbard (n_beta={TEMPERED_NBETA})"
    th_vmc, th_params, th_state, th_warm, th_launches = drive(
        th_label,
        lambda: VMC(
            RBM(n_inputs=2 * HUB_L, n_hiddens=HUB_H, dtype=torch.float32),
            hubbard,
            VMCConfig(n_walkers=HUB_K, learning_rate=1e-2, solver="cg", n_beta=TEMPERED_NBETA, seed=11),
            device=dev,
        ),
        HUB_WARM_SWEEPS, HUB_SR_STEPS, CACHE_ATOL,
    )
    want = expect(exchange=1 + HUB_SR_STEPS, exchange_tempered=1 + HUB_SR_STEPS)
    _require(th_launches == want and warm_launches[th_label]["exchange_tempered"] == 1,
             f"{th_label} launches {th_launches}: expected one launch of the tempered instance per sampler call")
    _require(sector_ok(th_warm.cache.spins) and sector_ok(th_state.cache.spins),
             f"{th_label}: a replica left the {HUB_PARTICLES}+{HUB_PARTICLES} sector")
    print(f"{th_label}: every replica holds {HUB_PARTICLES} up and {HUB_PARTICLES} down particles after the warm-up "
          "and the steps")
    path_launches["tempered Hubbard"] = th_launches
    # the instance with c: the FFNN Hubbard configuration on the same ladder
    tf_label = f"tempered FFNN Hubbard (n_beta={TEMPERED_NBETA})"
    _, _, tf_state, tf_warm, tf_launches = drive(
        tf_label,
        lambda: VMC(
            FFNN(n_inputs=2 * HUB_L, n_hiddens=FFNN_HUB_H, dtype=torch.float32),
            hubbard,
            VMCConfig(n_walkers=HUB_K, learning_rate=1e-2, solver="cg", n_beta=TEMPERED_NBETA, seed=11),
            device=dev,
        ),
        FFNN_HUB_WARM_SWEEPS, FFNN_HUB_SR_STEPS, CACHE_ATOL,
    )
    calls_t = 1 + FFNN_HUB_SR_STEPS
    _require(tf_launches == expect(exchange=calls_t, exchange_tempered=calls_t, exchange_tempered_c=calls_t),
             f"{tf_label} launches {tf_launches}: expected one launch of the tempered instance with c per sampler call")
    _require(sector_ok(tf_warm.cache.spins) and sector_ok(tf_state.cache.spins),
             f"{tf_label}: a replica left the {HUB_PARTICLES}+{HUB_PARTICLES} sector")
    path_launches["tempered FFNN Hubbard"] = tf_launches

    _enter("15 bench", t0)
    reset_counts()
    t_bench = time.perf_counter()
    bench_lines = port_bench.main([])
    torch.cuda.synchronize()
    bench_launches, bench_plain = read_counts()
    numbers = [v for line in bench_lines for k_, v in line.items() if isinstance(v, float) or k_ == "value"]
    print(f"bench: {len(bench_lines)} lines in {time.perf_counter() - t_bench:.1f} s; launches {bench_launches}; "
          f"plain-version calls: {bench_plain}")
    _require(len(bench_lines) == 5 and all(isinstance(v, float) and math.isfinite(v) for v in numbers),
             f"bench: lines {bench_lines}")
    _require(bench_lines[0]["value"] < BENCH_REL_ERR_BAR,
             f"bench: N=16 TFI relative error {bench_lines[0]['value']} not below {BENCH_REL_ERR_BAR}")
    _require(bench_plain == 0 and all(bench_launches[name] > 0 for name in ("sweep", "energy", "exchange", "chain_rate")),
             f"bench: launches {bench_launches}, plain calls {bench_plain}")
    path_launches["bench"] = bench_launches

    _enter("16 kernel device times", t0)
    # the instance each timed call runs: R = ceil(H/32) (exchange: G x U), then c and t
    hub_g = kernel_lanes(HUB_H)
    r_of = {"exchange": f"{hub_g}x{-(-HUB_H // hub_g)}"}

    def instance(name, tempered=False, multi=False):
        base = name.removesuffix("_c")
        # the float64 instance is in energy's library, the tempered one in exchange's
        lib = {"energy_f64": "energy", "exchange_tempered": "exchange", "chain_rate_energy": "chain_rate"}.get(base, base)
        f64, tempered = base == "energy_f64", tempered or base == "exchange_tempered"
        r = {"chain_rate": 0, "chain_rate_energy": 1}.get(base, r_of.get(lib, (h + 31) // 32))  # the probe: its body
        c = name.endswith("_c")
        key = (f"{r}" + ("c" if c else "") + ("t" if tempered and "t" in TEMPLATE_BOOLS[lib] else "")
               + ("m" if multi and c and "m" in TEMPLATE_BOOLS[lib] else "") + ("d" if f64 else ""))
        return key, ptxas[lib].get(key, "not built in this run")

    def device(fn, name):
        return _device_ms(torch, fn, 20, KERNEL_NAMES[name.removesuffix("_c")])

    device_ms = {name: device(fn, name) for name, (fn, _) in calls.items()}
    tempered_device_ms = {name: device(fn, name) for name, fn in tempered_calls.items()}
    uniform_device_ms = {name: device(fn, name) for name, fn in uniform_calls.items()}
    for title, table, tempered in (("", device_ms, False), (f" n_beta={CHECK_NBETA}", tempered_device_ms, True),
                                   (" on caller uniforms", uniform_device_ms, False)):
        for name, d_ms in table.items():
            key, regs = instance(name, tempered)
            print(f"{name}{title}: kernel {'not measured' if d_ms is None else f'{d_ms:.4f} ms'} per call "
                  f"(device time, profiler); instance {key}: registers {regs}")
    # the exchange kernel: one launch of several sweeps (tempered: at n_beta = 4)
    multi_ms = {name: device(lambda: exchange_cuda(w_, c_, bonds, multi_draws, n_beta=nb_, n_unit=n_unit), "exchange")
                for name, w_, c_, nb_ in (("exchange", hwork, hcache, 1), ("exchange_c", hfwork, hfcache, 1),
                                          ("exchange_tempered", hwork, hcache, TEMPERED_NBETA),
                                          ("exchange_tempered_c", hfwork, hfcache, TEMPERED_NBETA))}
    for name, d_ms in multi_ms.items():
        print(f"{name} {EXCHANGE_MULTI_SWEEPS} sweeps in one launch: kernel "
              f"{'not measured' if d_ms is None else f'{d_ms:.4f} ms'} per call (device time, profiler)")
    # the sweep kernel: a sampler call's MULTI_SWEEPS sweeps in one launch
    sweep_multi_device_ms = {name: device(fn, name) for name, fn in multi_calls.items()}
    for name, d_ms in sweep_multi_device_ms.items():
        key, regs = instance(name, multi=True)
        print(f"{name} {MULTI_SWEEPS} sweeps in one launch: kernel "
              f"{'not measured' if d_ms is None else f'{d_ms:.4f} ms'} per call (device time, profiler); "
              f"instance {key}: registers {regs}")

    _enter("17 LITFI step profile", t0)
    _profile_steps(torch, vmc, params, state, SR_STEPS)

    _enter("18 Hubbard step profile", t0)
    _profile_steps(torch, hub_vmc, hub_params, hub_state, HUB_SR_STEPS)

    _enter("19 FFNN flagship step profile", t0)
    _profile_steps(torch, ffnn_vmc, ffnn_params, ffnn_state, SR_STEPS)

    _enter("20 Hubbard minSR step profile", t0)
    _profile_steps(torch, ms_vmc, ms_params, ms_state, HUB_SR_STEPS, NEW_PROFILE_STEPS)

    _enter("21 2D dense SR step profile", t0)
    _profile_steps(torch, cb_vmc, cb_params, cb_state, TWO_D_STEPS, NEW_PROFILE_STEPS)

    _enter("22 tempered Hubbard step profile", t0)
    _profile_steps(torch, th_vmc, th_params, th_state, HUB_SR_STEPS)

    _enter("23 report", t0)
    print(f"launches by path: {json.dumps(path_launches)}")
    errs = {
        "sweep": {"max_abs_err": philox[("", 1)][1], "tolerance": SWEEP_LNPSI_ATOL, "mismatch_share": philox[("", 1)][0],
                  f"nbeta{CHECK_NBETA}_mismatch_share": philox[("", CHECK_NBETA)][0],
                  f"nbeta{CHECK_NBETA}_max_abs_err": philox[("", CHECK_NBETA)][1],
                  # the caller-uniform mode, which the tests and the A/B feed
                  "uniforms": {"max_abs_err": ln_err, "mismatch_share": share, f"nbeta{CHECK_NBETA}_mismatch_share": t_share,
                               f"nbeta{CHECK_NBETA}_max_abs_err": t_ln_err, "kernel_ms": uniform_device_ms["sweep"],
                               "wrapper_ms": uniform_ms["sweep"], "bound_ms": sweep_u_bound[0]},
                  f"nbeta{CHECK_NBETA}_bound_ms": sweep_t_bound[0],
                  # a sampler call's mode: MULTI_SWEEPS sweeps in one launch on one stream
                  "multi_sweep": {"sweeps": MULTI_SWEEPS, "max_abs_err": multi[("", 1)][1],
                                  "mismatch_share": multi[("", 1)][0],
                                  f"nbeta{CHECK_NBETA}_mismatch_share": multi[("", CHECK_NBETA)][0],
                                  "kernel_ms": sweep_multi_device_ms["sweep"], "wrapper_ms": sweep_multi_ms["sweep"],
                                  "bound_ms": sweep_m_bound[0], "registers": instance("sweep", multi=True)[1]},
                  "schedules_2d": {k: {"mismatch_share": v[0], "max_abs_err": v[1]} for k, v in two_d.items()}},
        "energy": {"max_abs_err": e_abs, "rel_err": e_rel, "tolerance": ENERGY_RTOL},
        # the headline: one sweep on the kernel's Philox stream, the training paths' mode
        "exchange": {"max_abs_err": x_ln_err, "tolerance": EXCHANGE_LNPSI_ATOL, "mismatch_share": x_share,
                     "uniforms": {"max_abs_err": xu_ln_err, "mismatch_share": xu_share,
                                  "kernel_ms": uniform_device_ms["exchange"], "wrapper_ms": uniform_ms["exchange"],
                                  "bound_ms": exchange_u_bound[0]},
                     "multi_sweep": {"sweeps": EXCHANGE_MULTI_SWEEPS, "max_abs_err": xm_ln_err, "mismatch_share": xm_share,
                                     "kernel_ms": multi_ms["exchange"], "bound_ms": exchange_m_bound[0]},
                     "lanes": hub_g, "w_in_shared_memory": stages_w(hn, HUB_H, n_bonds, False)},
        "sweep_energy": {"tolerance": SWEEP_LNPSI_ATOL, "offdiag_tolerance": OFFDIAG_RTOL, **mega[1],
                         f"nbeta{CHECK_NBETA}": mega[CHECK_NBETA], f"nbeta{CHECK_NBETA}_bound_ms": sweep_energy_t_bound[0],
                         "ab": {f"nbeta{nb}": {k: r[k] for k in ("two_kernel_ms", "megakernel_ms", "speedup")}
                                for nb, r in ab.items()}},
    }
    bounds = {"sweep": sweep_bound, "energy": energy_bound, "exchange": exchange_bound, "sweep_energy": sweep_energy_bound}
    replaces = {
        "sweep": "neural_network_quantum_state_tpu/ops/pallas_sweep.py:100",
        "energy": "neural_network_quantum_state_tpu/ops/pallas_energy.py:61",
        "exchange": "neural_network_quantum_state_tpu/ops/pallas_exchange.py:65",
        "sweep_energy": "neural_network_quantum_state_tpu/ops/pallas_sweep_energy.py:49",
    }
    # the instances with output weights c: the FFNN paths launched them
    ffnn_paths = ("FFNN LITFI", "FFNN Hubbard", "2D checkerboard", "LITFI FFNN energy_dtype float64")
    has_c_errs = {
        "sweep": {"max_abs_err": philox[(" with c", 1)][1], "tolerance": SWEEP_LNPSI_ATOL,
                  "mismatch_share": philox[(" with c", 1)][0],
                  f"nbeta{CHECK_NBETA}_mismatch_share": philox[(" with c", CHECK_NBETA)][0],
                  f"nbeta{CHECK_NBETA}_max_abs_err": philox[(" with c", CHECK_NBETA)][1],
                  "uniforms": {"max_abs_err": sweep_c[1][1], "mismatch_share": sweep_c[1][0],
                               f"nbeta{CHECK_NBETA}_mismatch_share": sweep_c[CHECK_NBETA][0],
                               f"nbeta{CHECK_NBETA}_max_abs_err": sweep_c[CHECK_NBETA][1],
                               "kernel_ms": uniform_device_ms["sweep_c"], "wrapper_ms": uniform_ms["sweep_c"],
                               "bound_ms": sweep_c_u_bound[0]},
                  f"nbeta{CHECK_NBETA}_bound_ms": sweep_c_t_bound[0],
                  "multi_sweep": {"sweeps": MULTI_SWEEPS, "max_abs_err": multi[(" with c", 1)][1],
                                  "mismatch_share": multi[(" with c", 1)][0],
                                  f"nbeta{CHECK_NBETA}_mismatch_share": multi[(" with c", CHECK_NBETA)][0],
                                  "kernel_ms": sweep_multi_device_ms["sweep_c"], "wrapper_ms": sweep_multi_ms["sweep_c"],
                                  "bound_ms": sweep_c_m_bound[0], "registers": instance("sweep_c", multi=True)[1]}},
        "energy": {"max_abs_err": ec_abs, "rel_err": ec_rel, "tolerance": ENERGY_RTOL, "near_cut_share": ec_near},
        "exchange": {"max_abs_err": xc_ln_err, "tolerance": EXCHANGE_LNPSI_ATOL, "mismatch_share": xc_share,
                     "uniforms": {"max_abs_err": xcu_ln_err, "mismatch_share": xcu_share,
                                  "kernel_ms": uniform_device_ms["exchange_c"], "wrapper_ms": uniform_ms["exchange_c"],
                                  "bound_ms": exchange_c_u_bound[0]},
                     "multi_sweep": {"sweeps": EXCHANGE_MULTI_SWEEPS, "max_abs_err": xcm_ln_err, "mismatch_share": xcm_share,
                                     "kernel_ms": multi_ms["exchange_c"], "bound_ms": exchange_c_m_bound[0]},
                     "w_in_shared_memory": stages_w(hn, FFNN_HUB_H, n_bonds, True)},
    }
    has_c_bounds = {"sweep": sweep_c_bound, "energy": energy_c_bound, "exchange": exchange_c_bound}

    def has_c(name):
        c = f"{name}_c"
        return {
            "launches": sum(path_launches[p][name] for p in ffnn_paths), **has_c_errs[name],
            "ms": device_ms[c] if device_ms[c] is not None else timing[c][0],
            "kernel_ms": device_ms[c], "wrapper_ms": timing[c][0], "plain_ms": timing[c][1],
            "bound_ms": has_c_bounds[name][0], "bound_by": has_c_bounds[name][1], "library_ms": None,
            "registers": instance(c)[1],
            **({f"nbeta{CHECK_NBETA}_kernel_ms": tempered_device_ms[c], f"nbeta{CHECK_NBETA}_wrapper_ms": tempered_ms[c]}
               if c in tempered_calls else {}),
        }

    kernels = [
        {
            "name": name, "route": "cuda",
            "source": f"neural_network_quantum_state_tpu_torch/csrc/{name}.cu",
            # launches: both instances, over every path; has_c: the instance with c alone
            "replaces": replaces[name], "launches": sum(p[name] for p in path_launches.values()),
            **errs[name],
            # ms: the kernel's device time; the wrapper's time where the profiler saw none
            "ms": device_ms[name] if device_ms[name] is not None else timing[name][0],
            "kernel_ms": device_ms[name], "wrapper_ms": timing[name][0], "plain_ms": timing[name][1],
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": None,
            "registers": instance(name)[1],
            **({f"nbeta{CHECK_NBETA}_kernel_ms": tempered_device_ms[name], f"nbeta{CHECK_NBETA}_wrapper_ms": tempered_ms[name]}
               if name in tempered_calls else {}),
            **({"has_c": has_c(name)} if name in has_c_errs else {}),
        }
        for name in ("sweep", "energy", "exchange", "sweep_energy")
    ]

    def f64_entry(name, err, bound):
        # launches: both float64 instances over every path; has_c: the instance with c alone
        return {"launches": sum(p.get(name, 0) for p in path_launches.values()),
                "max_abs_err": err[1], "rel_err": err[0], "tolerance": F64_ENERGY_RTOL,
                "ms": device_ms[name] if device_ms[name] is not None else timing[name][0],
                "kernel_ms": device_ms[name], "wrapper_ms": timing[name][0], "plain_ms": timing[name][1],
                "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None, "registers": instance(name)[1]}

    # the energy kernel's float64 instance (energy_dtype=float64), where the
    # JAX package runs XLA (hamiltonians/ising.py::_offdiag_sum in float64)
    kernels.append({
        "name": "energy_f64", "route": "cuda", "source": "neural_network_quantum_state_tpu_torch/csrc/energy.cu",
        "replaces": replaces["energy"], "instance_of": "energy",
        **f64_entry("energy_f64", f64_err[""], energy_f64_bound),
        "widths_rel_err": {k.strip(): v[0] for k, v in f64_err.items() if "H=" in k},
        "has_c": f64_entry("energy_f64_c", f64_err[" with c"], energy_f64_c_bound),
    })

    # the exchange kernel's tempered instance (tempered exchange), where the
    # JAX package runs XLA (sampler/kawasaki.py::tempered_exchange_sweeps): the
    # untempered instance's operations and bytes, the per-row swap counts
    # written, and SWAP_OPS per walker row and swap phase; headline n_beta = 4
    # at one sweep on its Philox stream
    swap_x_ops = 2 * HUB_K * SWAP_OPS

    def tempered_bound(hh, ops, uniforms, has_c, sweeps=1):
        # the swap counts out, the swap uniforms in on caller uniforms, c in
        nbytes = (exchange_bytes(hh, uniforms) + HUB_K * i32b + (2 * HUB_K * f32b if uniforms else 0)
                  + (hh * c64 if has_c else 0))
        return _bound_ms(sweeps * (ops + swap_x_ops), nbytes)

    def tempered_entry(clab, ops, hh):
        c = "_c" if clab else ""
        bound = tempered_bound(hh, ops, False, bool(clab))
        return {
            "n_beta": TEMPERED_NBETA, "max_abs_err": tempered_x[(clab, TEMPERED_NBETA, "philox")][1],
            "tolerance": EXCHANGE_LNPSI_ATOL, "mismatch_share": tempered_x[(clab, TEMPERED_NBETA, "philox")][0],
            f"nbeta{CHECK_NBETA}_mismatch_share": tempered_x[(clab, CHECK_NBETA, "philox")][0],
            f"nbeta{CHECK_NBETA}_max_abs_err": tempered_x[(clab, CHECK_NBETA, "philox")][1],
            "uniforms": {"max_abs_err": tempered_x[(clab, TEMPERED_NBETA, "uniforms")][1],
                         "mismatch_share": tempered_x[(clab, TEMPERED_NBETA, "uniforms")][0],
                         "kernel_ms": uniform_device_ms[f"exchange_tempered{c}"],
                         "wrapper_ms": uniform_ms[f"exchange_tempered{c}"],
                         "bound_ms": tempered_bound(hh, ops, True, bool(clab))[0]},
            "multi_sweep": {"sweeps": EXCHANGE_MULTI_SWEEPS,
                            "max_abs_err": tempered_x[(clab, TEMPERED_NBETA, "multi")][1],
                            "mismatch_share": tempered_x[(clab, TEMPERED_NBETA, "multi")][0],
                            "kernel_ms": multi_ms[f"exchange_tempered{c}"],
                            "bound_ms": tempered_bound(hh, ops, False, bool(clab), EXCHANGE_MULTI_SWEEPS)[0]},
            "ms": device_ms[f"exchange_tempered{c}"] if device_ms[f"exchange_tempered{c}"] is not None
            else timing[f"exchange_tempered{c}"][0],
            "kernel_ms": device_ms[f"exchange_tempered{c}"], "wrapper_ms": timing[f"exchange_tempered{c}"][0],
            "plain_ms": timing[f"exchange_tempered{c}"][1], "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": None, "registers": instance(f"exchange_tempered{c}")[1],
            f"nbeta{CHECK_NBETA}_kernel_ms": tempered_device_ms[f"exchange_tempered{c}"],
            f"nbeta{CHECK_NBETA}_wrapper_ms": tempered_ms[f"exchange_tempered{c}"],
            "w_in_shared_memory": stages_w(hn, hh, n_bonds, bool(clab), TEMPERED_NBETA),
        }

    kernels.append({
        "name": "exchange_tempered", "route": "cuda", "source": "neural_network_quantum_state_tpu_torch/csrc/exchange.cu",
        "replaces": replaces["exchange"], "instance_of": "exchange",
        # launches: the tempered instance's, over every path (counted in exchange's too)
        "launches": sum(p.get("exchange_tempered", 0) for p in path_launches.values()),
        **tempered_entry("", exchange_ops, HUB_H),
        # launches: the tempered instance with c alone, over every path
        "has_c": {"launches": sum(p.get("exchange_tempered_c", 0) for p in path_launches.values()),
                  **tempered_entry(" with c", exchange_c_ops, FFNN_HUB_H)},
    })

    # the chain-rate probe: 2^22 elements in and out (x, y) once, CHAIN_LEN
    # bodies each; bound by the FMA pipes' float32 rate or the MUFU's, which
    # ever is slower, or by the bytes
    def chain_entry(body, name):
        elems = N_ELEMS * CHAIN_LEN
        fma_ms, mufu_ms = 1e3 * elems * CHAIN_OPS[body] / PEAK_F32_FLOPS, 1e3 * elems * CHAIN_MUFU[body] / PEAK_MUFU_S
        bytes_ms = 1e3 * 4 * N_ELEMS * f32b / PEAK_BYTES_S
        ms = device_ms[name] if device_ms[name] is not None else timing[name][0]
        return {"body": body, **chain_err[body], "tolerance": CHAIN_RTOL, "near_cut_max": CHAIN_NEAR_CUT_MAX,
                "ms": ms, "kernel_ms": device_ms[name], "wrapper_ms": timing[name][0], "plain_ms": timing[name][1],
                "bound_ms": max(fma_ms, mufu_ms, bytes_ms),
                "bound_by": "operations" if max(fma_ms, mufu_ms) >= bytes_ms else "bytes",
                "bound_fma_ms": fma_ms, "bound_mufu_ms": mufu_ms, "bound_bytes_ms": bytes_ms, "library_ms": None,
                "registers": instance(name)[1], "elements_per_s": elems / (ms / 1e3),
                "bench_elements_per_s": port_bench.probe_rates(dev).get(body)}

    kernels.append({
        "name": "chain_rate", "route": "cuda", "source": "neural_network_quantum_state_tpu_torch/csrc/chain_rate.cu",
        "replaces": "bench.py:105", "launches": sum(p.get("chain_rate", 0) for p in path_launches.values()),
        **chain_entry("sweep", "chain_rate"), "energy_body": chain_entry("energy", "chain_rate_energy"),
    })
    print(f"solver cross-check: {json.dumps(solver_check)}; auto's MINRES-QLP fallbacks: {json.dumps(auto_fallbacks)}")
    print(json.dumps({"kernels": kernels}))
    print(_smi())  # the card's name and power limit, as nvidia-smi prints them
    print(f"# total {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sass"]:
        print("\n".join(_sass_report(sys.argv[2:])))
        sys.exit(0)
    rc = main()
    sys.stdout.flush()
    os._exit(rc)
