#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed with its seconds:
1. a CUDA device must be present (else exit 1); print its name and power limit;
2. build the CUDA kernels with nvcc (one process per source, in parallel:
   the exchange kernel's untempered and tempered instances are two
   sources, the sweep's float64 instances a third, the exchange's float64
   ones two more); print each instance's registers and spill bytes (the
   energy kernel's two float64 instances, which serve every width, must not
   spill; the sweep's float64 instances are one per R, c and tempered
   class, the exchange's one per (G, U) of lanes_for, c and tempered
   class), and the SASS instructions per element of the sweep's, the
   energy (float32 and float64), the exchange kernel's and the float64
   sweep's and exchange's hot loops (their proposal rounds with the
   accept) and of the megakernel's proposal round and energy loop; the
   float64 exchange's RBM round must stay below the double instructions per
   element that one library transcendental per unit would add, and the
   megakernel's two loops at n_beta = 1 at 0.05 MUFU an element (its factor
   form takes no transcendental per element);
3. at full width hold each kernel against its plain PyTorch version on the
   same inputs and time both with CUDA events: the sweep and energy kernels
   at the LITFI flagship's N=64, H=256, K=8192 (the sweep at n_beta = 1 and
   at n_beta = 8, with its in-kernel replica exchange), the fused
   sweep + energy megakernel at that shape against the sweep kernel followed
   by the energy kernel on the same uniforms and against its plain version
   (n_beta = 1 and 8), and on the stress inputs of utils/f32_stress.py
   (|Re w| = 20, a unit near a zero of cosh, large |Re y|; N = 16, K = 512)
   against its plain version in float64, with its refusal of |Re w| = 20.5
   before any launch, the exchange kernel at the Hubbard flagship's N=64,
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
   against its plain float64 version at full width, at H = 16, 80, 200,
   256, 384 and 512 and on the stress inputs of
   utils/f64_stress.py (N = 16 and 72), with and without c (the
   walkers near the branch cut, at float64's tolerance, counted apart), to
   a relative 1e-12; the exchange kernel's tempered
   instance (tempered exchange: n_beta > 1, its swap phases in the kernel)
   against the plain tempered exchange at the Hubbard flagship's shape, at
   n_beta = 4 and 8, with and without c (FFNN(64, 64)), on its Philox stream
   (one sweep and 5 in one launch) and on caller uniforms, with the
   exchange gates by chain (where rows part, the chains whose closest
   decision in their first parting sweep lies within 4 float32 roundings
   of its tie, utils/ties.py, are printed with their margins and may be at
   most 1% of the chains; the other parting chains' rows count against the
   exchange's 1e-3 of the rows) and every replica in its sector, and at
   H = 16, 80 and 384; the hot-math chain-rate probe, both bodies at bench.py's size
   (2^22 elements, 32 bodies a chain), against its plain version to a
   relative 1e-5 of the largest |value| (the elements whose energy-body
   chain takes a phase near the branch cut left out, their share bounded);
   every sweep and exchange instance (float32 and float64, n_beta = 1 and
   tempered, with and without c) on its Philox stream at row0 = K/2, the
   counter offset of a walker mesh's shard, against its plain version;
   the sweep's float64 instances against the plain float64 sweep (the
   flagship widened to complex128, its Philox stream and float64 caller
   uniforms, n_beta = 1 and 8, 5 sweeps in one launch, with and without c;
   H = 16, 80, 384, 512; the sweep's stress inputs of utils/f64_stress.py,
   |Re w| = 25 among them, at N = 16 and 72, and at N = 16 a launch of 100
   sweeps on the |Re w| = 25 one) and the exchange's float64
   instances against the plain float64
   (tempered) exchange at the Hubbard flagship's shape (n_beta = 1, 4 and 8,
   the three modes, with and without c, every sector kept; H = 16, 80,
   384; the stress inputs on two rings of N/2 sites at N = 16 and 72, and
   at N = 16 a launch of 100 sweeps on the |Re w| = 25 one): decisions as the
   float32 gates,
   near-cut walkers counted with them, y to 1e-12 of its largest |value|
   and ln psi to 1e-10 on the others; weights past the float64 kernels'
   range (|Re w| > 43) refused by the sweep, exchange and energy wrappers
   with no launch;
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
   cross-check and the time of each arm (the wrappers, CUDA events; the
   kernels' device times are phase 16's);
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
15b. the train driver (``drivers.train.main``, as ``python -m
   neural_network_quantum_state_tpu_torch.drivers.train`` runs it): the
   LITFI flagship (-model=LICH -ansatz=rbmtrsymm -L=64 -nf=4 -alpha=2.5
   -theta=2 -ns=8192) warm-started with -ifprefix from a copy of
   runs/RBMTrSymmLICH-L64NF4A2.5T2V1, 100 warm-up sweeps and 20 steps
   auto-saved every 10, then -resume for 5 more (steps 20..24, lambda at
   step 20 = 100 * 0.9^21); the same model with -dtype=float64 -ns=4096
   (100 + 10, the float64 sweep and energy instances); the L=32 trap
   Hubbard chain in float64 (-ns=4096, 100 + 5, the float64 exchange
   instance, every walker of the saved state in its sector); both float64
   models again with -nbeta=4 (50 + 3: the float64 sweep's and exchange's
   tempered instances, every replica in its sector); each run's
   files (text checkpoint, .state.npz, .metrics.jsonl) under the build
   directory, its launches (one per sampler call of the right instance,
   the float64 energy instance once per float64 step), no plain version,
   finite energies; its step ms, init + warm-up seconds and peak memory.
   The Orbax arm: the flagship again with -ckpt=orbax (100 + 20, saved
   every 10 as an .orbax directory and no .state.npz), resumed from the
   .orbax directory for 5 (steps 20..24, lambda as above); then the two
   committed JAX -ckpt=orbax runs (tests/fixtures/jax_orbax, one device
   and -mesh=4: OCDBT, zstd chunks, the mesh's walkers in 4 chunks), each
   read onto the card equal to its text checkpoint to 8 digits (step 5,
   walkers +-1) and resumed for 3 steps (5..7); the host seconds of every
   save and load and of decoding each JAX run;
15c. the measure driver (``drivers.measure.main``, as ``python -m
   neural_network_quantum_state_tpu_torch.drivers.measure`` runs it), each
   run on a copy of a recorded checkpoint under the build directory: (a)
   the Binder production run at full width and depth (-what=stag -L=64
   -ns=8192 -nbeta=8 -niter=300 -nms=3 -nwarm=500 on
   runs/RBMTrSymmLICH-L64NF4A2.5T0.95V9: 1 + 300 launches of the sweep's
   n_beta = 8 instance, 0 <= m1^2 <= m2 <= 1, m4 <= m2, the campaign's
   `binder=` grep); (b) the L=32 Hubbard trap (runs/RBMHB-L32U4V2) at the
   recorded depth (5000 + 300 x 3; the OPDM 5000 + 150 x 3): the energy
   within 1e-3 of the recorded -0.1185681, the density summing to 10 within
   1e-4 and within 0.05 of the recorded profile at every site, OPDM(16,16)
   and OPDM(16,17) within 0.01 of the recorded row (1 + 301, 1 + 300,
   1 + 16 x 150 exchange launches), then -nbeta=4 at a cut depth through
   the tempered instance,
   every replica in its sector; (c) the deep-ordered Renyi increment run
   (runs/RBMTrSymmLICH-L64NF4A2.5T1.57V9, -l=32 -z2q=1 -init=neel, depth
   cut): S2 within 2e-3 of ln 2, no kernel (plain PyTorch glued sweeps);
   (d) energy (the energy kernel), renyi, fidelity, overlap, smag,
   corrratio, zz, xx, neel and a float64 smag (the sweep's float64
   instance) on the flagship checkpoint at full width, small depth; (e)
   RBMTrSymm(16, alpha=4) against exact enumeration of its 2^16 states on
   the card (smag m2, zz, xx, renyi and renyi_inc at l = 8, fidelity) at
   n_beta = 1 and 4. Each run: launches per kernel instance (one per
   sampler call), no plain version, finite values, wall s, iterations/s
   and peak memory;
15d. the walker mesh (``parallel.make_mesh(4)``: four shards of this card)
   through the user's entry points, the counts set to 0 before each run:
   (a) the LITFI flagship (K=8192, 100 warm-up sweeps, 10 SR steps) on one
   device and on the mesh, the same seed: the warm-up spins equal to the
   bit, the step-0 energy within 1e-6 relative, 4 sweep launches per
   sampler call and 4 energy launches per step, no plain version, both
   step times; (b) the L=32 trap on the mesh (500 warm-up sweeps, 5 steps,
   4 exchange launches per call, every shard in its sector) and both
   tempered flagships (n_beta = 4, 3 steps); (c) the flagship on the 2D
   mesh (2, 2) and the TP mesh (2, 2), 3 steps, within 1e-6 of the 1D
   mesh's energies; (d) the train driver with -mesh=4 (warm-started as in
   15b, 20 steps, then -resume for 5), -dtype=float64 -mesh=2 (50 + 3),
   -gridmesh=2 on two thetas (two threads, 2 shards each), and the measure
   driver -what=stag -mesh=4 at small depth; (e) the pynqs-style API
   (``api.sampler.RBM``, floatType float32, symmType tr) on a copy of the
   flagship checkpoint: one sweep launch per do_mcmc_steps, get_lnpsi
   within 1e-4 of get_lnpsi_for_fixed_spins(get_spinStates());
15e. the precision anchor (``examples.precision_anchor``): the port's
   Lanczos ED of the LITFI chain at N = 20 (theta = 2, alpha_J = 2.5) on
   the host, held to the JAX package's recorded E0
   (logs/precision_anchor_ed_N20.json) to 1e-8 relative; then
   RBMTrSymm(20, alpha = 4), K = 8192, trained on the card at the full
   protocol (500 warm-up sweeps, then 3000 x 2e-2, 3000 x 5e-3 and
   2000 x 2e-3 SR steps with the float64 solve, seed 11): 1 + 8000 sweep
   launches and 8000 energy launches, no plain version; the mean energy of
   the last 1000 steps within 1e-4 relative of the trained state's own
   <H> (enumeration of its 2^20 configurations in float64, which must not
   lie below E0); its relative error against E0 printed beside the paper's
   bar of 1e-4 (met or not: ROADMAP C10) and the recorded JAX error, with
   the step ms, ED and training seconds;
16. the device time of each kernel and instance on phase 3's inputs
   (torch.profiler; the sweep and exchange in the main paths' Philox mode,
   and also on caller uniforms), beside the instance's registers and spill
   bytes from the build, the exchange's and the sweep's 5-sweep launches,
   the energy kernel's float64 instance, the exchange's tempered instance,
   the sweep's and the exchange's float64 instances and the chain-rate
   probe; the float64 sweep's and exchange's bounds (the operations the
   function needs) beside their RBM forms' floors (the operations they
   issue, their reads through L1), the time of their table,
   their wrappers' times with a fresh weight tensor a call (the table and
   its range check built anew) and the float64 exchange's SASS per element;
17. profile 5 more LITFI SR steps, 18. 5 more Hubbard SR steps, 19. 5 more
   FFNN flagship SR steps, 20. 3 more Hubbard minSR steps, 21. 3 more 2D
   dense SR steps, 22. 5 more tempered Hubbard SR steps, 22b. 5 more
   estimator iterations of the Binder run and of the Hubbard energy run.
The profiler runs only after the timed phases 4 to 15d, so that it cannot
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

import itertools
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time

LIMIT_S = 600  # the watchdog: half the 1200 s a run of this script may take, the build included
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
# Phase 15e: the precision anchor at N = 20 (examples/precision_anchor.py's full protocol); the port's
# ED against the JAX package's recorded E0 (logs/precision_anchor_ed_N20.json) to this relative tolerance
ANCHOR_N, ANCHOR_E0_RTOL = 20, 1e-8
# the card's tail energy against the exact <H> of the state it trained to (enumeration, float64): the
# sampling and the float32 energy kernel unbiased to within the paper's bar
ANCHOR_ENUM_RTOL = 1e-4
CACHE_ATOL = 2e-4  # y carried through the warm-up's 6400 proposals vs a fresh forward
TEMPERED_NBETA, CHECK_NBETA = 4, 8  # the tempered flagship's ladder; the phase-3 and A/B ladder
# Widths off the multiples of 32 (the e2e oracle, the precision anchors,
# the Binder N=96 leg) at small K; the same tolerances as above.
WIDTHS, WIDTH_N, WIDTH_K = (16, 80, 384), 32, 512
WIDTH_MISMATCH_MAX = 1e-2  # at K=512 one near-tie is 2e-3 of the walkers
OFFDIAG_RTOL = 1e-5  # megakernel vs the two kernels / plain, on walkers with the same decisions
# The megakernel on utils/f32_stress.py's inputs (|Re w| = 20, a unit near a
# zero of cosh, large |Re y|) at N = 16, K = WIDTH_K, n_beta 1 and 8, held to
# the plain megakernel in float64 from the same state (the plain float32
# version's dln loses about 3e-4 there): decisions within WIDTH_MISMATCH_MAX,
# y within SWEEP_Y_ATOL of its largest |value| (float32's ulp at |y| = 45 is
# 4e-6), its sums within OFFDIAG_RTOL of the plain float64 sum on its own
# final state; past the range (ops/engine.py F32_MAX_RE_W) by
# F32_PAST_RANGE the wrapper raises and launches nothing.
F32_STRESS_N, F32_PAST_RANGE = 16, 0.5
# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores, HBM3.
PEAK_F32_FLOPS, PEAK_BYTES_S = 67e12, 3.35e12
# Operations per (walker, proposal or site, hidden unit) that each function
# needs, one count per function whatever implements it (float32 or float64,
# log-cosh or factor form), counting the factor form's, which needs no
# transcendental per element: the sweep 11 (the multiply-add c + u G with the
# state's c real 7, |.|^2 3, the running product 1), with output weights c
# 24 (the multiply-add 7, |.|^2 3, the log and its half 2, atan2 1, the
# phase 3 and its wrap 4, the sum c.re ln|.| - c.im phase 4); the
# off-diagonal sum 13 (the multiply-add 7, the complex product 6), with c 28
# (the sweep's 20 before its sum, and the complex sum c (ln|.| + i phase) 8).
# (The float32 log-cosh kernels' own forms issue about 20 and 25, 23 and 29
# with c.)
SWEEP_OPS, SWEEP_OPS_C, ENERGY_OPS, ENERGY_OPS_C = 11, 24, 13, 28
# The exchange proposal: 11 per hidden unit as the sweep (the factor of a
# pair flip, e^{4 s (w_i - w_k)}, is one table entry), 25 with c (the
# difference of the two sites' Im w, 1, more), and 2 per bond for the active
# mask (a product and a compare); the count and pick over the mask (a
# popcount per 32 bonds) are left out. (The float32 log-cosh form does
# about 22.)
EXCHANGE_OPS_HIDDEN, EXCHANGE_OPS_HIDDEN_C, EXCHANGE_OPS_BOND = 11, 25, 2
EXCHANGE_MULTI_SWEEPS = 5  # the sweeps of the one-launch comparison
# A replica-exchange phase per walker row: the difference of Re ln psi, the
# beta-scaled min, the exp, the compare and the select.
SWAP_OPS = 5
MULTI_SWEEPS = 5  # the sweep kernel's one-launch comparison (a sampler call's mode)
# The energy kernel's float64 instance: its bar against the plain float64
# sum, and the H100 SXM's float64 rate outside the tensor cores (NVIDIA data
# sheet), over which its operations are bounded.
F64_ENERGY_RTOL, PEAK_F64_FLOPS = 1e-12, 34e12
# Its widths (every R = ceil(H/32) class: partial tiles of 32 units at 16,
# 80 and 200, the flagship's 256, 384, the widest 512) and its stress inputs
# (utils/f64_stress.py) at N = 16 and 72 (one pass of 64 sites
# and two), K = 300 (a partial block); with c at most 1% of those walkers
# near the branch cut (its float64 tolerance), counted apart.
F64_WIDTHS, F64_STRESS_N, F64_STRESS_K, F64_STRESS_NEAR_MAX = (16, 80, 200, 256, 384, 512), (16, 72), 300, 1e-2
# Its RBM form's own floors per (walker, site, hidden unit): 14 double
# operations (the complex multiply-add c + u G, 8, and the product's complex
# multiply, 6), and 16 bytes of shared memory read (G; the lanes on distinct
# sites) at the H100 SXM's 128 bytes per clock per SM on 132 SMs at 1.98 GHz.
F64_FORM_OPS, F64_FORM_SMEM_BYTES, PEAK_SMEM_BYTES_S = 14, 16, 132 * 128 * 1.98e9
# The sweep and exchange kernels' float64 instances (csrc/sweep_f64.cu,
# csrc/exchange_f64.cu) against their plain float64 versions: y to a
# relative F64_Y_RTOL of its largest |value| and ln psi to F64_LNPSI_ATOL on
# the walkers with the same decisions (the decision gates are the float32
# instances'); their widths (every one of them serves all H) and the stress
# inputs of utils/f64_stress.py (sweep), N = 16 and 72, K = 300.
F64_Y_RTOL, F64_LNPSI_ATOL = 1e-12, 1e-10
F64_SWEEP_WIDTHS, F64_EXCHANGE_WIDTHS = (16, 80, 384, 512), (16, 80, 384)
# The float64 sweep's and exchange's launch of a warm-up's F64_LONG_SWEEPS
# sweeps on the stress input of F64_LONG_CASE at N = 16, with and without
# c: the drift of many accepted flips at the range's factors, |Re w| = 25
# (the plain twin of such a launch takes about 1 s; the gpu tests' launches
# of 100 sweeps run at the flagships' shapes).
F64_LONG_SWEEPS, F64_LONG_CASE = 100, "Re w 25"
# The float64 sweep's and exchange's bounds count SWEEP_OPS(_C) and
# EXCHANGE_OPS_HIDDEN(_C), the functions' own counts.
# Beside the bound, what the RBM forms issue on top (csrc/sweep_f64.cu,
# csrc/exchange_f64.cuh): the sweep a power of two per pair of factors
# (11.5), the exchange one per factor (12); and their 16 bytes of G or of
# the bond table's row read through L1 at the shared-memory/L1 rate of
# PEAK_SMEM_BYTES_S. Both are floors of the forms, not of the function.
F64_SWEEP_FORM_OPS, F64_EXCHANGE_FORM_OPS, F64_FORM_ROW_BYTES = 11.5, 12, 16
# Past the float64 kernels' range (ops/engine.py F64_MAX_RE_W) the sweep,
# exchange and energy wrappers raise and launch nothing: phase 3 moves the
# "Re w 25" inputs' |Re w| = 25 to this far past it.
F64_PAST_RANGE = 1.0
# The train driver's runs (phase 15b): the LITFI flagship warm-started from
# the recorded run, its resume, the same model in float64 at the N=64
# anchor's walker count, and the Hubbard trap chain in float64.
DRIVER_RUN = "runs/RBMTrSymmLICH-L64NF4A2.5T2V1"
DRIVER_WARM, DRIVER_STEPS, DRIVER_NREC, DRIVER_RESUME_STEPS = 100, 20, 10, 5
DRIVER_F64_K, DRIVER_F64_WARM, DRIVER_F64_STEPS = 4096, 100, 10
DRIVER_HUB_WARM, DRIVER_HUB_STEPS = 100, 5
DRIVER_TEMPERED_WARM, DRIVER_TEMPERED_STEPS = 50, 3  # both float64 models at n_beta = 4
# The JAX package's -ckpt=orbax runs committed for phase 15b's Orbax arm
# (scripts/make_jax_orbax_fixtures.py: LITFI L=16, RBMTrSymm alpha 2, 512
# walkers, float32, saved at step 5; one device and -mesh=4), each resumed
# here for JAX_ORBAX_STEPS steps. Their text checkpoints print 8 digits.
JAX_ORBAX_FIXTURES = "tests/fixtures/jax_orbax"
JAX_ORBAX_PREFIX = "RBMTrSymmLICH-L16NF2A2T0V1"
JAX_ORBAX_ARGV = ["-model=LICH", "-ansatz=rbmtrsymm", "-L=16", "-nf=2", "-ns=512"]
JAX_ORBAX_STEP, JAX_ORBAX_STEPS, JAX_ORBAX_TEXT_RTOL = 5, 3, 1e-7
# The measure driver's runs (phase 15c), each on a copy of a recorded
# checkpoint under the build directory (the driver writes its files next to
# -prefix, and runs/ holds the anchors): (a) the Binder production run
# (scripts/binder_final_measure.sh:27-29) at full depth; (b) the L=32
# Hubbard trap at full depth (logs/hubbard_trap_{energy,density,opdm}_eq.log;
# the OPDM's iterations cut to half),
# held to the recorded energy (the seeds read -0.1185681 and -0.11902, the
# unequilibrated run +0.232), density and OPDM files, then tempered
# (-nbeta=4) at a cut depth; (c) the deep-ordered Renyi run
# (logs/renyi_z2q_N64_T157.log: S2 = ln 2 by the ansatz's symmetry), its
# depth cut from 400 + 500 to 20 + 30, so that the run stays inside its
# watchdog; (d) the other modes at full width, small depth.
MEAS_BINDER_RUN, MEAS_HUB_RUN = "runs/RBMTrSymmLICH-L64NF4A2.5T0.95V9", "runs/RBMHB-L32U4V2"
MEAS_HUB_ENERGY, MEAS_HUB_ENERGY_TOL = -0.1185681, 1e-3
MEAS_SUM_N, MEAS_SUM_TOL, MEAS_DENSITY_TOL, MEAS_OPDM_TOL = 10.0, 1e-4, 0.05, 0.01
MEAS_OPDM_ITERS = 150  # the OPDM's iterations, cut from the recorded 300 (16 launches each) for the watchdog
MEAS_TEMPERED_WARM, MEAS_TEMPERED_ITERS = 500, 50
MEAS_RENYI_RUN, MEAS_RENYI_TOL = "runs/RBMTrSymmLICH-L64NF4A2.5T1.57V9", 2e-3
MEAS_RENYI_WARM, MEAS_RENYI_ITERS = 20, 30
MEAS_FLAGSHIP, MEAS_FLAGSHIP2 = "runs/RBMTrSymmLICH-L64NF4A2.5T2V1", "runs/RBMTrSymmLICH-L64NF4A2.5T2V2"
MEAS_SMALL_WARM, MEAS_SMALL_ITERS, MEAS_XX_ITERS, MEAS_F64_K = 100, 20, 2, 4096
MEAS_PROFILE_ITERS = 5  # the profiled estimator iterations of (a) and (b) (phase 22b)
# The walker mesh (phase 15d): MESH_SHARDS shards of the one card; the
# LITFI flagship's warm-up and MESH_STEPS steps on one device and on the
# mesh (the step-0 energy within MESH_E0_RTOL, and the 2D and TP layouts'
# energies of the 1D mesh's); the trap and both tempered flagships at a cut
# depth; the train driver's grid of two thetas; the API sampler's calls,
# its ln psi on its own spins within MESH_API_ATOL.
MESH_SHARDS, MESH_STEPS, MESH_E0_RTOL = 4, 10, 1e-6
MESH_HUB_STEPS, MESH_HUB_WARM, MESH_TEMPERED_STEPS, MESH_LAYOUT_STEPS = 5, 100, 3, 3
MESH_GRID_STEPS, MESH_API_WARM, MESH_API_CALLS, MESH_API_ATOL = 3, 10, 3, 1e-4
# (e): RBMTrSymm(16, alpha=4), its init parameters times 4, against exact
# enumeration on the card at n_beta = 1 and 4 (EXACT_K chains of n_beta
# replicas); the tolerances are absolute (renyi_inc: also 5 of its errors).
EXACT_N, EXACT_ALPHA, EXACT_SCALE, EXACT_L, EXACT_K = 16, 4, 4.0, 8, 4096
EXACT_ITERS, EXACT_XX_ITERS, EXACT_SWEEPS, EXACT_WARM = 50, 20, 2, 200
EXACT_INC_WALKERS, EXACT_INC_WARM = 512, 100
EXACT_TOL = {"smag m2": 2e-3, "zz": 0.02, "xx": 0.015, "renyi": 0.02, "renyi_inc": 0.01, "fidelity": 5e-3}
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
                "exchange_tempered": "exchange_kernel", "chain_rate": "chain_kernel", "chain_rate_energy": "chain_kernel",
                "sweep_f64": "sweep_kernel_f64", "exchange_f64": "exchange_kernel_f64",
                "exchange_f64_tempered": "exchange_kernel_f64"}
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


def _bound_ms(ops: float, nbytes: float, peak_flops: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = ops / peak_flops, nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _profile(torch, run, n: int, unit: str) -> dict | None:
    """Device time by kernel over run(), n units of work (SR steps, estimator
    iterations; torch.profiler), and the share of the window in which the
    card ran no kernel; returns the per-unit wall and busy ms and the idle
    share (None where the profiler saw no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    rows = [  # device-side events only (kernels, copies): host ops would count their kernels twice
        (ev.self_device_time_total / 1e3 / n, ev.count / n, ev.key)
        for ev in prof.key_averages()
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
    ]
    busy = sum(r[0] for r in rows)
    if busy == 0:
        print(f"{unit} profile: the profiler recorded no device time (device busy share not measured)")
        return None
    idle = 1.0 - busy * n / wall_ms
    print(f"{unit} profile ({n} {unit}s, profiler on): wall {wall_ms / n:.3f} ms/{unit}, device busy "
          f"{busy:.3f} ms/{unit} in {sum(r[1] for r in rows):.0f} device events/{unit}, idle share {idle:.3f}")
    ranked = sorted(rows, reverse=True)
    always = (*KERNEL_NAMES.values(), "conj")  # the kernels, and the conjugate copies of the CG solve
    for ms, count, key in ranked[:8] + [r for r in ranked[8:] if any(k in r[2] for k in always)]:
        print(f"  {ms:8.4f} ms/{unit}  {count:6.1f} calls/{unit}  {key[:90]}")
    return {"wall_ms": wall_ms / n, "busy_ms": busy, "idle_share": idle}


def _profile_steps(torch, vmc, params, state, step0: int, n_steps: int = 5) -> None:
    """Device time by kernel over a few more SR steps (``_profile``)."""

    def run():
        p, st = params, state
        for i in range(n_steps):
            p, st, _ = vmc.step(p, st, step0 + i)

    _profile(torch, run, n_steps, "step")


def _exact_estimators(dev, n_beta: int) -> dict:
    """Phase 15c (e): the estimators of RBMTrSymm(EXACT_N, alpha=EXACT_ALPHA)
    with fixed seeded parameters (times EXACT_SCALE), sampled on `dev`
    with an n_beta ladder, beside their exact values from enumerating the
    2^EXACT_N states on `dev` with the same parameters: name -> (got,
    want, tolerance)."""
    import numpy as np
    import torch

    from neural_network_quantum_state_tpu_torch.measurements import (
        AmplitudeSampler, fidelity, renyi2_entropy, renyi2_increment, spin_x_correlation, spin_z_correlation,
        spontaneous_magnetization,
    )
    from neural_network_quantum_state_tpu_torch.models import RBMTrSymm
    from neural_network_quantum_state_tpu_torch.ops import engine
    from neural_network_quantum_state_tpu_torch.ops.rng import make_generator

    n, l = EXACT_N, EXACT_L
    machine = RBMTrSymm(n_inputs=n, alpha=EXACT_ALPHA, dtype=torch.float32)

    def params(seed):
        return {k: EXACT_SCALE * v.to(dev) for k, v in machine.init_params(make_generator(seed, "cpu")).items()}

    p1, p2 = params(1), params(2)
    idx = torch.arange(2**n, device=dev)
    basis = (1 - 2 * ((idx[:, None] >> torch.arange(n, device=dev)) & 1)).to(torch.float32)

    def psi(p):  # the normalized amplitudes over the basis, on the host
        ln = engine.log_psi(machine.make_work(p), basis).to(torch.complex128)
        v = torch.exp(ln - ln.real.max())
        return (v / torch.linalg.vector_norm(v)).cpu().numpy()

    psi1, psi2 = psi(p1), psi(p2)
    s, prob, flip = basis.double().cpu().numpy(), np.abs(psi1) ** 2, np.arange(2**n)
    mat = psi1.reshape(2 ** (n - l), 2**l)
    rho = mat.T @ mat.conj()
    s2_exact = float(-np.log(np.real(np.trace(rho @ rho))))
    want_x = np.array([np.real(np.vdot(psi1, psi1[flip ^ (1 << i)])) for i in range(n)])
    want_xx = np.array([[np.real(np.vdot(psi1, psi1[flip ^ (1 << i) ^ (1 << j)])) if i != j else 1.0
                         for j in range(n)] for i in range(n)])

    def smp(seed, p=p1):
        return AmplitudeSampler(machine, p, EXACT_K * n_beta, key=seed, n_beta=n_beta, device=dev)

    out = {}
    _, m2, _ = spontaneous_magnetization(smp(11), EXACT_ITERS, EXACT_SWEEPS, EXACT_WARM)
    out["smag m2"] = (m2, float((prob * s.mean(1) ** 2).sum()), EXACT_TOL["smag m2"])
    zz = spin_z_correlation(smp(12), EXACT_ITERS, EXACT_SWEEPS, EXACT_WARM)
    out["zz"] = (zz, (s[:, :, None] * s[:, None, :] * prob[:, None, None]).sum(0), EXACT_TOL["zz"])
    sx, sxx = spin_x_correlation(smp(13), EXACT_XX_ITERS, EXACT_SWEEPS, EXACT_WARM)
    out["x"] = (sx, want_x, EXACT_TOL["xx"])
    out["xx"] = (sxx, want_xx, EXACT_TOL["xx"])
    out[f"renyi l={l}"] = (renyi2_entropy(smp(14), smp(15), l, EXACT_ITERS, EXACT_SWEEPS, EXACT_WARM), s2_exact,
                           EXACT_TOL["renyi"])
    s2_inc, s2_err, _ = renyi2_increment(machine, p1, l, EXACT_ITERS, 1, EXACT_INC_WARM,
                                         walkers_per_level=EXACT_INC_WALKERS * n_beta, key=16, n_beta=n_beta,
                                         device=dev)
    out[f"renyi_inc l={l}"] = (s2_inc, s2_exact, max(5 * s2_err, EXACT_TOL["renyi_inc"]))
    f_val, _ = fidelity(smp(17), smp(18, p2), EXACT_ITERS, EXACT_WARM, EXACT_SWEEPS)
    out["fidelity"] = (f_val, float(abs(np.vdot(psi1, psi2))), EXACT_TOL["fidelity"])
    return out


# the template parameters of each kernel after R: C (output weights c), T
# (the sweep's tempered instance, n_beta > 1), M (the sweep's launch of
# more than one sweep with c) and N (the float64 sweep's and exchange's
# narrow tempered instances, blocks of at most 8 warps), as the instances
# are named
TEMPLATE_BOOLS = {"sweep": "ctm", "energy": "c", "exchange": "ct", "exchange_tempered": "ct", "sweep_energy": "t",
                  "chain_rate": "", "sweep_f64": "ctn", "exchange_f64": "ctn", "exchange_f64_tempered": "ctn"}


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
# The energy kernel's float64 instances (one per family, every R): their unit
# loop, 8 hidden units (kUnroll in csrc/energy.cu) of each of a lane's 2
# sites, one 16-byte shared-memory load of the table an element;
# double-precision opcodes.
SASS_F64 = (("Lb0E", "energy float64 RBM"), ("Lb1E", "energy float64 has_c"))
SASS_F64_ELEMENTS = 16
SASS_FP64 = ("DFMA", "DMUL", "DADD", "DSETP", "DMNMX")
# The sweep's float64 instances at R = 8, n_beta = 1 and n_beta > 1: their
# proposal round (the innermost loop with the warp's butterfly shuffles and
# R loads of the G row), over its R hidden units of a lane.
SASS_SWEEP_F64 = (("Lb0ELb0ELb0E", "sweep float64 RBM"), ("Lb0ELb1ELb0E", "sweep float64 RBM tempered"),
                  ("Lb1ELb0ELb0E", "sweep float64 has_c"))
# The exchange's float64 instances of the Hubbard flagship (H = 64: G = 16,
# U = 4): their proposal round (the smallest loop without a barrier with the
# walker's butterfly over G lanes and U loads of the bond table's row), over
# the U units of a lane. The form needs about 8 double instructions an
# element, its accept about 7 more and a proposal's own about 16 (4 an
# element); the library's exp, log, cos, sincos or atan2 of each unit would
# add 11 to 40 more: the RBM round's gate.
SASS_EXCHANGE_F64_G, SASS_EXCHANGE_F64_U = 16, 4
SASS_EXCHANGE_F64 = (("Lb0ELb0ELb0E", "exchange float64 RBM"), ("Lb0ELb1ELb0E", "exchange float64 RBM tempered"),
                     ("Lb1ELb0ELb0E", "exchange float64 has_c"))
SASS_EXCHANGE_F64_DOUBLE_MAX = 36
# The megakernel's 32-lane R = 8 instances (H = 256; n_beta = 1, then
# tempered): its proposal round with its accept (the smallest loop without a
# barrier with R to 4R - 1 global loads, the G row and on an accept the G and
# w rows, and the warp's butterfly), over its R units, and its energy loop
# (at least 4R global loads, the G rows of a group of 4 sites, and the
# reduce-scatter's shuffles), over 4R elements. Its factor form takes no transcendental per element: at n_beta
# = 1 at most SASS_MEGA_MUFU_MAX MUFU an element in either loop (a tempered
# proposal takes three lg2 for its test).
SASS_MEGA = (("0", "megakernel"), ("1", "megakernel tempered"))
SASS_MEGA_MUFU_MAX = 0.05


def _loops(ins):
    """The backward-branch loops of a function's (address, opcode) list, as
    lists of opcodes."""
    out = []
    for a, op in ins:
        m = re.search(r"BRA (?:\S+ )?0x([0-9a-f]+)", op)
        if m and int(m.group(1), 16) < a:
            out.append([o for x, o in ins if int(m.group(1), 16) <= x <= a])
    return out


def _opcodes(body) -> list[str]:
    return [re.sub(r"^@!?U?P\w+\s+", "", o).split()[0].split(".")[0] for o in body]


def _per_element(label, body, per) -> str:
    ops = _opcodes(body)
    fp, mufu, ldl = sum(o in SASS_FP for o in ops), ops.count("MUFU"), ops.count("LDL")
    fp64, calls = sum(o in SASS_FP64 for o in ops), ops.count("CALL")
    return (f"{label}: loop of {len(body)} instructions for {per} elements: "
            f"{len(body) / per:.1f} per element, {fp / per:.1f} floating-point/MUFU "
            f"(MUFU {mufu / per:.2f}, LDL {ldl / per:.2f})" + (f", double {fp64 / per:.1f}" if fp64 else "")
            + (f", calls {calls}" if calls else ""))


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
    has it). The energy kernel's float64 instances: the smallest loop without
    a barrier and with at least 16 DFMA and 16 LDS.128 (the table's loads),
    over its 8 units x 2 sites (the library's log and atan2 with c count as
    far as they are inlined; a loop of theirs, which loads no table, is
    not taken for the unit loop). The sweep's float64 instances at R = 8:
    the smallest loop without a barrier with five butterfly shuffles (the
    warp's product) and R loads of the G row, a proposal round with its
    accept, over its R units (calls: the accept's division's slow path).
    The exchange's float64 instances at G = 16, U = 4: the smallest loop
    without a barrier with the group's butterfly (at least 2 log2 G
    shuffles) and U global loads (the bond table's row), a proposal round
    with its accept, over its U units.
    Cold paths inside the loop count too (a library sincosf's slow
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
    for flag, label in SASS_F64:
        names = [n for n in funcs if re.search(rf"offdiag_kernel_f64I{flag}E", n)]
        if not names:
            continue
        loops = [body for body in _loops(funcs[names[0]])
                 if _opcodes(body).count("DFMA") >= SASS_F64_ELEMENTS and not any("BAR" in o for o in body)
                 and sum("LDS.128" in o for o in body) >= SASS_F64_ELEMENTS]
        if not loops:
            lines.append(f"{label}: no unit loop found")
            continue
        lines.append(_per_element(label, min(loops, key=len), SASS_F64_ELEMENTS))
    for flags, label in SASS_SWEEP_F64:
        names = [n for n in funcs if re.search(rf"sweep_kernel_f64ILi{SASS_R}E{flags}E", n)]
        if not names:
            continue
        loops = [body for body in _loops(funcs[names[0]])
                 if sum("SHFL.BFLY" in o for o in body) >= 5 and sum("LDG" in o for o in body) >= SASS_R
                 and not any("BAR" in o for o in body)]
        if not loops:
            lines.append(f"{label}: no proposal loop found")
            continue
        lines.append(_per_element(f"{label} (R={SASS_R}, a proposal round with its accept)", min(loops, key=len),
                                  SASS_R))
    for flag, label in SASS_MEGA:
        names = [n for n in funcs if re.search(rf"sweep_energy_kernelILi32ELi{SASS_R}ELb{flag}E", n)]
        if not names:
            continue
        loops = [(body, sum("LDG" in o for o in body)) for body in _loops(funcs[names[0]])
                 if not any("BAR" in o for o in body)]
        rounds = [b for b, n_ldg in loops if SASS_R <= n_ldg < 4 * SASS_R and sum("SHFL.BFLY" in o for o in b) >= 5]
        sites = [b for b, n_ldg in loops if n_ldg >= 4 * SASS_R and sum("SHFL" in o for o in b) >= 9]
        lines.append(_per_element(f"{label} sweep (R={SASS_R}, a proposal round with its accept)", min(rounds, key=len),
                                  SASS_R) if rounds else f"{label} sweep: no proposal loop found")
        lines.append(_per_element(f"{label} energy (R={SASS_R}, a group of 4 sites)", min(sites, key=len),
                                  4 * SASS_R) if sites else f"{label} energy: no site loop found")
    g, u = SASS_EXCHANGE_F64_G, SASS_EXCHANGE_F64_U
    for flags, label in SASS_EXCHANGE_F64:
        names = [n for n in funcs if re.search(rf"exchange_kernel_f64ILi{g}ELi{u}E{flags}E", n)]
        if not names:
            continue
        loops = [body for body in _loops(funcs[names[0]])
                 if sum("SHFL.BFLY" in o for o in body) >= 2 * int(math.log2(g)) and sum("LDG" in o for o in body) >= u
                 and not any("BAR" in o for o in body)]
        if not loops:
            lines.append(f"{label}: no proposal loop found")
            continue
        lines.append(_per_element(f"{label} (G={g}, U={u}, a proposal round with its accept)", min(loops, key=len), u))
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


def _compare(label, ck, lk, cp, lp, mismatch_max, y_atol, ln_atol, failures, cut=False, exempt=None):
    """Kernel vs plain states from the same inputs and uniforms: the share
    of walkers with other decisions, and y and ln psi on the others. With
    output weights c (cut=True) a walker whose final y has a hidden unit
    near the principal log-cosh's branch cut in either state, where ln psi
    may jump by 2 pi i c_j between them, counts with the other decisions.
    The rows of `exempt` (a (K,) mask: the near-tie chains of a tempered
    exchange, gated apart) count in neither. Appends to `failures`; returns
    (share, ln_err, mask of agreeing walkers)."""
    from neural_network_quantum_state_tpu_torch.ops.logcosh import near_branch_cut

    differ = (ck.spins != cp.spins).any(dim=1)
    exempt = differ.new_zeros(differ.shape) if exempt is None else exempt
    differ = differ & ~exempt
    near = (near_branch_cut(ck.y) | near_branch_cut(cp.y)) & ~differ & ~exempt if cut else differ.new_zeros(differ.shape)
    same = ~(differ | near | exempt)
    share = float((differ | near).double().mean())
    y_err = float((ck.y[same] - cp.y[same]).abs().max())
    ln_err = float((lk[same] - lp[same]).abs().max())
    k = differ.shape[0]
    print(f"{label}: walkers with other decisions {int(differ.sum())}" + (f" + near the cut {int(near.sum())}" if cut else "")
          + f"/{k} = {share:.2e} (max {mismatch_max:.0e})" + (f", rows of near-tie chains set apart {int(exempt.sum())}"
                                                             if bool(exempt.any()) else "")
          + f"; on the others max|dy| {y_err:.3e} (tol {y_atol:.0e}), max|dlnpsi| {ln_err:.3e} (tol {ln_atol:.0e})")
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
    import numpy as np
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
    from neural_network_quantum_state_tpu_torch.examples import precision_anchor
    from neural_network_quantum_state_tpu_torch import bench as port_bench
    from neural_network_quantum_state_tpu_torch.hamiltonians import HubbardChain, LITFIChain, TFICheckerBoard, TFITRI
    from neural_network_quantum_state_tpu_torch.models import FFNN, FFNNTrSymm, RBM, RBMSfSymm, RBMTrSymm
    from neural_network_quantum_state_tpu_torch.ops import build, engine
    from neural_network_quantum_state_tpu_torch.ops.chain_rate import (
        BODIES, CHAIN_LEN, N_ELEMS, chain_cuda, chain_near_cut, chain_plain, probe_inputs,
    )
    from neural_network_quantum_state_tpu_torch.ops.energy import (
        offdiag_near_cut, offdiag_sum_cuda, offdiag_sum_plain,
    )
    from neural_network_quantum_state_tpu_torch.ops.exchange import (
        exchange_cuda, exchange_plain, kernel_lanes, stages_w, tempered_exchange_plain,
    )
    from neural_network_quantum_state_tpu_torch.ops.rng import (
        ExchangeDraws, PhiloxDraws, make_generator, philox_key, random_spins, uniform_block,
    )
    from neural_network_quantum_state_tpu_torch.ops.sweep import sweep_cuda, sweep_plain
    from neural_network_quantum_state_tpu_torch.ops.sweep_energy import sweeps_offdiag_cuda, sweeps_offdiag_plain
    from neural_network_quantum_state_tpu_torch.sampler.kawasaki import two_ring_bonds
    from neural_network_quantum_state_tpu_torch.optim import solvers
    from neural_network_quantum_state_tpu_torch.optim.minres import sr_minres_solve
    from neural_network_quantum_state_tpu_torch.optim.sr import (
        LAMBDA_MIN, build_s_matrix, force_vector, lambda_schedule, sr_cg_solve, sr_dense_solve, sr_minsr_solve,
    )
    from neural_network_quantum_state_tpu_torch.utils import ties
    from neural_network_quantum_state_tpu_torch.utils.f32_stress import F32_STRESS, f32_stress_inputs
    from neural_network_quantum_state_tpu_torch.utils.f64_stress import F64_STRESS, f64_stress_inputs

    wrappers = {"sweep": sweep_cuda, "energy": offdiag_sum_cuda, "exchange": exchange_cuda,
                "sweep_energy": sweeps_offdiag_cuda, "chain_rate": chain_cuda}
    plains = (sweep_plain, offdiag_sum_plain, exchange_plain, sweeps_offdiag_plain, chain_plain)

    def reset_counts():
        for fn in wrappers.values():
            fn.launches = 0
        offdiag_sum_cuda.launches_f64 = offdiag_sum_cuda.launches_f64_c = 0
        exchange_cuda.launches_tempered = exchange_cuda.launches_tempered_c = 0
        sweep_cuda.launches_f64 = exchange_cuda.launches_f64 = exchange_cuda.launches_f64_tempered = 0
        for fn in plains:
            fn.calls = 0

    def read_counts():
        """The launches of each kernel ("energy_f64": the energy kernel's
        float64 instances, "energy_f64_c": those of them with c;
        "exchange_tempered": the exchange kernel's tempered instance, counted
        in "exchange" too, "exchange_tempered_c": those of them with c;
        "sweep_f64", "exchange_f64": the float64 instances of the sweep and
        the exchange, "exchange_f64_tempered": the tempered ones of the
        latter, counted in "exchange_f64" too) and the calls of all plain
        versions (the plain tempered exchange calls the plain exchange)."""
        counts = {name: fn.launches for name, fn in wrappers.items()}
        counts["energy_f64"] = offdiag_sum_cuda.launches_f64
        counts["energy_f64_c"] = offdiag_sum_cuda.launches_f64_c
        counts["exchange_tempered"] = exchange_cuda.launches_tempered
        counts["exchange_tempered_c"] = exchange_cuda.launches_tempered_c
        counts["sweep_f64"] = sweep_cuda.launches_f64
        counts["exchange_f64"] = exchange_cuda.launches_f64
        counts["exchange_f64_tempered"] = exchange_cuda.launches_f64_tempered
        return counts, sum(fn.calls for fn in plains)

    def expect(**want):
        """The launch counts of a path: the given ones, 0 for every other kernel."""
        return {name: want.get(name, 0)
                for name in (*wrappers, "energy_f64", "energy_f64_c", "exchange_tempered", "exchange_tempered_c",
                             "sweep_f64", "exchange_f64", "exchange_f64_tempered")}

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
    # the energy kernel's float64 instances: one per family serves every 1 <= H <= 512
    f64_regs = {key: v for key, v in ptxas["energy"].items() if key.endswith("d")}
    print(f"energy float64 instances (d; cd: with c), every R = 1..16: registers {f64_regs}")
    _require(set(f64_regs) == {"d", "cd"} or not built["energy"].seconds,
             f"energy float64 instances {sorted(f64_regs)}, expected d and cd")
    _require(not any("B" in v for v in f64_regs.values()), f"energy float64 instances spill: {f64_regs}")
    # the sweep's float64 instances: one per (R, c, tempered) and the RBM family's narrow tempered ones above
    # R = 8; the exchange's: one per (c, tempered), every H
    print(f"sweep_f64 instances (R, then c: with c, t: tempered, n: narrow, d), registers[+spill]: "
          f"{_ptxas_summary(ptxas['sweep_f64'])}")
    want = ({f"{r}{c}{t}d" for r in range(1, 17) for c in ("", "c") for t in ("", "t")}
            | {f"{r}tnd" for r in range(9, 17)})
    _require(set(ptxas["sweep_f64"]) == want or not built["sweep_f64"].seconds,
             f"sweep_f64 instances {sorted(ptxas['sweep_f64'])}, expected R = 1..16 each with and without c and t, "
             "and R = 9..16 tn")
    # the exchange's: one per (G, U) that lanes_for reaches, c, and n_beta class (two sources)
    reached = [(16, u) for u in range(1, 9)] + [(32, u) for u in range(5, 17)]
    for lib, t in (("exchange_f64", ""), ("exchange_f64_tempered", "t")):
        print(f"{lib} instances (G x U, then c: with c, t: tempered, d), registers[+spill]: "
              f"{_ptxas_summary(ptxas[lib])}")
        want = {f"{g_}x{u_}{c}{t}d" for g_, u_ in reached for c in ("", "c")}
        if t:  # and the RBM family's narrow tempered ones at G = 32 above U = 8
            want |= {f"32x{u_}tnd" for u_ in range(9, 17)}
        _require(set(ptxas[lib]) == want or not built[lib].seconds,
                 f"{lib} instances {sorted(ptxas[lib])}, expected the (G, U) of lanes_f64 each with and without c, "
                 "and the narrow tempered ones")
    t_sass = time.perf_counter()
    sass_lines = _sass_report([built[name].path for name in ("sweep", "energy", "exchange", "sweep_energy", "sweep_f64",
                                                             "exchange_f64", "exchange_f64_tempered")])
    print(f"SASS report: {time.perf_counter() - t_sass:.1f} s")
    for line in sass_lines:
        print(f"SASS per element: {line}")
    # the float64 exchange's RBM-family round issues no library transcendental per unit: its double
    # instructions per element stay below what one exp, log, cos, sincos or atan2 of it would add
    x_rbm = [line for line in sass_lines if "exchange float64 RBM (" in line]
    if x_rbm:
        dbl = float(re.search(r"double ([\d.]+)", x_rbm[0]).group(1))
        calls = int(re.search(r"calls (\d+)", x_rbm[0]).group(1)) if "calls" in x_rbm[0] else 0
        _require(dbl <= SASS_EXCHANGE_F64_DOUBLE_MAX and calls <= 1,
                 f"the float64 exchange's RBM round: {x_rbm[0]} (at most {SASS_EXCHANGE_F64_DOUBLE_MAX} double "
                 "instructions an element and one call, the division's slow path)")

    # the megakernel's factor form at n_beta = 1: no transcendental per element in its proposal or energy loop
    mega_sass = [line for line in sass_lines if re.search(r"megakernel (sweep|energy) \(", line)]
    for line in mega_sass:
        mufu = float(re.search(r"MUFU ([\d.]+)", line).group(1))
        _require(mufu <= SASS_MEGA_MUFU_MAX, f"{line} (at most {SASS_MEGA_MUFU_MAX} MUFU an element)")
    _require(len(mega_sass) == 2, f"the megakernel's SASS loops: {mega_sass or 'none found'}")

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

    # the megakernel on the stress inputs against the plain megakernel in float64, and its refusal past the range
    def widened(w_, c_):
        w64 = engine.Work(*(None if t is None else t.to(torch.complex128) for t in w_))
        c64 = engine.Cache(c_.spins.double(), c_.y.to(torch.complex128), c_.sa.to(torch.complex128))
        return w64, c64, engine.cache_log_psi(w64, c64)

    mega_stress = {}
    ssched = torch.as_tensor(LITFIChain(n_sites=F32_STRESS_N).schedule())
    sg = make_generator(4321, dev)  # its own stream: the later checks draw their inputs from g as before
    for case in F32_STRESS:
        sw_, sb_, sa_, ss_ = f32_stress_inputs(case, seed=17, n=F32_STRESS_N, k=WIDTH_K)
        swork = engine.Work(*(torch.as_tensor(x, dtype=torch.complex64, device=dev) for x in (sw_, sb_, sa_)))
        scache, _ = engine.full_forward(swork, torch.as_tensor(ss_, dtype=torch.float32, device=dev))
        w64, c64, l64 = widened(swork, scache)
        for nb in (1, CHECK_NBETA):
            su = uniform_block(sg, (F32_STRESS_N, WIDTH_K))
            sus = uniform_block(sg, (1, 2, WIDTH_K)) if nb > 1 else None
            cm, _, am, om = sweeps_offdiag_cuda(swork, scache, ssched, su, nb, sus)
            cp, _, _, _ = sweeps_offdiag_plain(w64, c64, l64, ssched, su.double(), nb,
                                               None if sus is None else sus.double())
            same = (cm.spins.double() == cp.spins).all(1)
            s_share = 1.0 - float(same.double().mean())
            y_rel = float((cm.y[same].to(torch.complex128) - cp.y[same]).abs().max() / cp.y.abs().max())
            fw, fc, fl = widened(swork, cm)
            want = offdiag_sum_plain(fw, fc, fl)
            o_rel = float((om.to(torch.complex128) - want).abs().max() / want.abs().max())
            finite = bool(torch.isfinite(om).all())
            print(f"sweep_energy {case} n_beta={nb} (N={F32_STRESS_N}, K={WIDTH_K}) vs plain float64: other decisions "
                  f"{s_share:.2e} (max {WIDTH_MISMATCH_MAX:.0e}), y {y_rel:.3e} of max|y| (tol {SWEEP_Y_ATOL:.0e}); "
                  f"offdiag vs the float64 sum on its state {o_rel:.3e} (tol {OFFDIAG_RTOL:.0e}); accepted "
                  f"{float(am):.0f}, finite {finite}")
            if not (s_share <= WIDTH_MISMATCH_MAX and y_rel <= SWEEP_Y_ATOL and o_rel <= OFFDIAG_RTOL and finite
                    and float(am) > 0):
                failures.append(f"sweep_energy {case} n_beta={nb}: decisions {s_share:.2e}, y {y_rel:.3e}, "
                                f"offdiag {o_rel:.3e}, finite {finite}")
            mega_stress[f"{case} n_beta={nb}"] = {"mismatch_share": s_share, "y_rel_err": y_rel, "offdiag_rel_err": o_rel}
        if case == "Re w 20":
            before = sweeps_offdiag_cuda.launches
            past = swork._replace(w=swork.w + F32_PAST_RANGE * (swork.w.real == engine.F32_MAX_RE_W))
            try:
                sweeps_offdiag_cuda(past, scache, ssched, su)
                refused = False
            except ValueError as exc:
                refused = "Re w" in str(exc)
            torch.cuda.synchronize()
            no_launch = sweeps_offdiag_cuda.launches == before
            print(f"sweep_energy: |Re w| = {engine.F32_MAX_RE_W + F32_PAST_RANGE} refused {refused}, "
                  f"no launch {no_launch}")
            if not (refused and no_launch):
                failures.append(f"sweep_energy: |Re w| past the range: refused {refused}, no launch {no_launch}")
            mega_stress["refused_past_range"] = refused and no_launch

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
    tie_log = []  # C9: the parting chains of the float32 tempered checks

    def tie_check(label, w_, c_, bonds_, uniforms, n_beta, n_unit_, differ, mismatch_max):
        """C9's gate of a float32 tempered exchange check whose rows part
        (``utils/ties.py``): each parting chain's closest decision in its
        first parting sweep, printed with its margin; the near-tie chains
        (within ties.NEAR float32 roundings of a tie) fail the check above
        ties.NEAR_CHAINS_MAX of the chains, the other chains' rows count
        against `mismatch_max` of the rows in ``_compare``. Returns the mask
        of the near-tie chains' rows."""
        chains, n_near, _, _ = ties.find_ties(w_, c_, bonds_, uniforms, n_beta, n_unit_)
        gate = ties.tie_gate(chains, differ, n_beta, mismatch_max)
        for ch in chains:
            print(f"{label}: chain {ch['chain']} apart after sweep {ch['first_sweep']} ({ch['rows_apart_at_end']} rows at "
                  f"the end), its closest decision's margin {ch['margin']:.3e} against a rounding of dln of "
                  f"{ch['rounding']:.3e}: {ch['margin_in_roundings']} roundings, "
                  + ("a near-tie" if ch["near_tie"] else "not a near-tie"))
        print(f"{label}: rows apart {gate['rows_apart']}, of them in near-tie chains {gate['rows_apart'] - gate['other_rows']}; "
              f"near-tie chains {gate['near_tie_chains']}/{gate['chains']} (max {ties.NEAR_CHAINS_MAX:.0%}); decisions "
              f"within {ties.NEAR:g} roundings of a tie on the plain path: {n_near}")
        tie_log.append({"check": label, "chains": chains, **{k: v for k, v in gate.items() if k != "near_rows"}})
        if gate["near_tie_chains"] > ties.NEAR_CHAINS_MAX * gate["chains"]:
            failures.append(f"{label}: {gate['near_tie_chains']} near-tie chains of {gate['chains']}")
        return gate["near_rows"]

    def exchange_vs_plain(label, w_, c_, ln_, bonds_, uniforms, mismatch_max, cut, n_beta=1, swaps=None,
                          tols=(EXCHANGE_Y_ATOL, EXCHANGE_LNPSI_ATOL), n_unit_=None, by_chain=False):
        """Kernel vs plain exchange rounds on the same uniforms (an
        ExchangeDraws, or the (u_sel, u_acc) pair; for n_beta > 1 the
        tempered instance against the plain tempered exchange, in sweeps of
        N proposals, with the (n_sweeps, 2, K) swap uniforms beside the
        pair); the sectors kept, per flavor half, in every walker row (the
        walkers start with the same particle numbers, so a row holds them
        whichever replica's configuration it ends with); `tols` the y and
        ln psi tolerances; `n_unit_` at n_beta = 1 the kernel's sweep (its
        float64 instances renew their state after each); `by_chain` (the
        float32 tempered checks at the flagship's shape) gates the rows
        by chain, as ``tie_check`` says. Returns (share, ln_err,
        acceptance)."""
        args = (uniforms,) if isinstance(uniforms, ExchangeDraws) else uniforms
        k_, n_ = c_.spins.shape
        exempt = None
        if c_.spins.dtype == torch.float32:  # the float32 instances' two W branches
            seen = staged_seen if n_beta == 1 else staged_seen_t
            seen.add((w_.c is not None, stages_w(n_, w_.w.shape[1], bonds_.shape[0], w_.c is not None, n_beta)))
        if n_beta > 1:
            kw = {"n_beta": n_beta, "n_unit": n_, "swap_uniforms": swaps}
            ck, lk, rows_k = exchange_cuda(w_, c_, bonds_, *args, **kw)
            cp, lp, rows_p = tempered_exchange_plain(w_, c_, ln_, bonds_, *args, **kw)
            acc_p = rows_p[0].sum()
            differ = (ck.spins != cp.spins).any(1)
            if by_chain and bool(differ.any()):  # C9: the gate by chain
                exempt = tie_check(label, w_, c_, bonds_, uniforms if swaps is None else (*uniforms, swaps),
                                   n_beta, n_, differ, mismatch_max)
        else:
            ck, lk, rows_k = exchange_cuda(w_, c_, bonds_, *args, n_unit=n_unit_)
            cp, lp, acc_p = exchange_plain(w_, c_, ln_, bonds_, *args)
        acc_k = rows_k[0].sum()
        share_, ln_err_, _ = _compare(label, ck, lk, cp, lp, mismatch_max, *tols, failures, cut=cut, exempt=exempt)
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
                                                                 EXCHANGE_MISMATCH_MAX, bool(clab), nb, sw,
                                                                 by_chain=True)[:2]
        xk, _, _ = exchange_cuda(w_, c_, bonds, multi_draws, n_beta=TEMPERED_NBETA, n_unit=n_unit)
        if not sector_ok(xk.spins):
            failures.append(f"exchange tempered{clab}: a replica left its particle sector")
    print(f"exchange tempered: C9's parting chains: {json.dumps(tie_log)}")

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

    _enter("3b float64 kernels vs plain", t0)
    # the energy kernel's float64 instance against the plain float64 sum
    def widened(w_, c_):
        w64 = engine.Work(*(None if t is None else t.to(torch.complex128) for t in w_))
        return (w64, *engine.full_forward(w64, c_.spins.double()))

    def f64_vs_plain(label, w64, c64, l64, near_max):
        """(relative error over the walkers away from the branch cut (all
        of them without c), its absolute error, the near-cut share)."""
        got, want = offdiag_sum_cuda(w64, c64), offdiag_sum_plain(w64, c64, l64)
        near = (offdiag_near_cut(w64, c64) if w64.c is not None
                else torch.zeros(got.shape[0], dtype=torch.bool, device=dev))
        far = ~near
        abs_ = float((got - want)[far].abs().max())
        rel, share = abs_ / float(want[far].abs().max()), float(near.double().mean())
        print(f"energy float64{label}: max|kernel-plain| / max|plain| {rel:.3e} (tol {F64_ENERGY_RTOL:.0e})"
              + (f" on the walkers away from the cut; near the cut {int(near.sum())}/{near.shape[0]} (max share "
                 f"{near_max:.0e}); over all walkers {_rel(got, want):.3e}" if w64.c is not None else ""))
        if not (math.isfinite(rel) and rel <= F64_ENERGY_RTOL and share <= near_max):
            failures.append(f"energy float64{label}: relative error {rel:.3e}, near-cut share {share:.2e}")
        return rel, abs_, share

    f64_cases = {"": widened(work, cache), " with c": widened(fwork, fcache)}
    f64_err = {label: f64_vs_plain(label, *args, SWEEP_MISMATCH_MAX) for label, args in f64_cases.items()}
    for wh in F64_WIDTHS:
        for label, wm in (("", RBM(n_inputs=WIDTH_N, n_hiddens=wh)),
                          (" with c", FFNN(n_inputs=WIDTH_N, n_hiddens=wh, dtype=torch.float32))):
            wwork = ffnn_work(wm) if label else wm.make_work({k: PARAM_SCALE * v for k, v in wm.init_params(g).items()})
            f64_err[f" H={wh}{label}"] = f64_vs_plain(
                f" H={wh}{label}", *widened(wwork, engine.full_forward(wwork, random_spins(g, WIDTH_K, WIDTH_N))[0]),
                WIDTH_MISMATCH_MAX)
    for case in F64_STRESS:
        for sn in F64_STRESS_N:
            for label in ("", " with c"):
                w_, b_, a_, c_, s_ = f64_stress_inputs(case, bool(label), seed=sn, n=sn, k=F64_STRESS_K)
                w64 = engine.Work(*(None if x is None else torch.as_tensor(x, device=dev) for x in (w_, b_, a_, c_)))
                f64_err[f" {case}, N={sn}{label}"] = f64_vs_plain(
                    f" {case}, N={sn}{label}", w64, *engine.full_forward(w64, torch.as_tensor(s_, device=dev)),
                    F64_STRESS_NEAR_MAX)

    # the sweep's and the exchange's float64 instances (csrc/sweep_f64.cu,
    # csrc/exchange_f64.cu) against their plain float64 versions on the same
    # uniforms: the Philox stream (its float32 numbers, widened) and float64
    # caller uniforms; n_beta = 1 and the ladders; with and without c (the
    # walkers near the branch cut, at float64's tolerance, with the other
    # decisions); y to F64_Y_RTOL of its largest |value|, ln psi to
    # F64_LNPSI_ATOL on the others
    def f64_tols(c_):
        return F64_Y_RTOL * float(c_.y.abs().max()), F64_LNPSI_ATOL

    def sweep64_vs_plain(label, w64, c64, l64, sched_, draws, nb, mismatch_max):
        args = (draws, nb) if isinstance(draws, PhiloxDraws) else (draws[0], nb, draws[1] if nb > 1 else None)
        ck, lk, acc_k = sweep_cuda(w64, c64, sched_, *args)
        cp, lp, _ = sweep_plain(w64, c64, l64, sched_, *args)
        out = _compare(f"sweep float64{label}", ck, lk, cp, lp, mismatch_max, *f64_tols(cp), failures,
                       cut=w64.c is not None)
        n_rounds = draws.n_rounds if isinstance(draws, PhiloxDraws) else draws[0].shape[0]
        acc = float(acc_k) / (n_rounds * c64.spins.shape[0])
        if not 0.0 < acc < 1.0:
            failures.append(f"sweep float64{label}: acceptance {acc}")
        return out[:2]

    f64_u, f64_us = uniform_block(g, (N, K), torch.float64), uniform_block(g, (1, 2, K), torch.float64)
    sweep64 = {}
    for clab in ("", " with c"):
        for nb in (1, CHECK_NBETA):
            modes = [("philox", PhiloxDraws(philox_key(g), N)), ("uniforms", (f64_u, f64_us))]
            if nb == 1:  # a sampler call's mode: several sweeps in one launch
                modes.append(("multi", PhiloxDraws(philox_key(g), MULTI_SWEEPS * N)))
            for mode, draws in modes:
                sweep64[(clab, nb, mode)] = sweep64_vs_plain(f"{clab} n_beta={nb} {mode}", *f64_cases[clab], sched,
                                                             draws, nb, SWEEP_MISMATCH_MAX)
    for wh in F64_SWEEP_WIDTHS:
        wsched = torch.as_tensor(LITFIChain(n_sites=WIDTH_N).schedule())
        for clab, wm in (("", RBM(n_inputs=WIDTH_N, n_hiddens=wh)),
                         (" with c", FFNN(n_inputs=WIDTH_N, n_hiddens=wh, dtype=torch.float32))):
            wwork = ffnn_work(wm) if clab else wm.make_work({k: PARAM_SCALE * v for k, v in wm.init_params(g).items()})
            w64c = widened(wwork, engine.full_forward(wwork, random_spins(g, WIDTH_K, WIDTH_N))[0])
            for nb in (1, CHECK_NBETA):
                sweep64[(f" H={wh}{clab}", nb, "philox")] = sweep64_vs_plain(
                    f" H={wh}{clab} n_beta={nb} philox", *w64c, wsched, PhiloxDraws(philox_key(g), 2 * WIDTH_N), nb,
                    WIDTH_MISMATCH_MAX)
    for case in F64_STRESS:
        for sn in F64_STRESS_N:
            for clab in ("", " with c"):
                w_, b_, a_, c_, s_ = f64_stress_inputs(case, bool(clab), seed=sn, n=sn, k=F64_STRESS_K)
                w64 = engine.Work(*(None if x is None else torch.as_tensor(x, device=dev) for x in (w_, b_, a_, c_)))
                sweep64[(f" {case}, N={sn}{clab}", 1, "philox")] = sweep64_vs_plain(
                    f" {case}, N={sn}{clab} philox", w64, *engine.full_forward(w64, torch.as_tensor(s_, device=dev)),
                    torch.arange(sn, dtype=torch.int32, device=dev), PhiloxDraws(philox_key(g), sn), 1,
                    F64_STRESS_NEAR_MAX)
    # a warm-up's launch of F64_LONG_SWEEPS sweeps on F64_LONG_CASE (N = 16): the factor state renewed
    # at every start of the schedule, its drift bounded by one sweep
    sn = F64_STRESS_N[0]
    for clab in ("", " with c"):
        w_, b_, a_, c_, s_ = f64_stress_inputs(F64_LONG_CASE, bool(clab), seed=sn, n=sn, k=F64_STRESS_K)
        w64 = engine.Work(*(None if x is None else torch.as_tensor(x, device=dev) for x in (w_, b_, a_, c_)))
        sweep64_vs_plain(
            f" {F64_LONG_CASE}, N={sn}{clab} {F64_LONG_SWEEPS} sweeps in one launch", w64,
            *engine.full_forward(w64, torch.as_tensor(s_, device=dev)), torch.arange(sn, dtype=torch.int32, device=dev),
            PhiloxDraws(philox_key(g), F64_LONG_SWEEPS * sn), 1, F64_STRESS_NEAR_MAX)
    # the exchange at the Hubbard flagship's shapes, widened, and at H = 16, 80, 384
    h64_cases = {"": widened(hwork, hcache), " with c": widened(hfwork, hfcache)}
    x64_sel, x64_acc = uniform_block(g, (n_unit, HUB_K), torch.float64), uniform_block(g, (n_unit, HUB_K), torch.float64)
    x64_swap = uniform_block(g, (1, 2, HUB_K), torch.float64)
    exchange64 = {}
    for clab, (w64, c64, l64) in h64_cases.items():
        for nb in (1, TEMPERED_NBETA, CHECK_NBETA):
            for mode, unif, sw in (("philox", exchange_draws, None), ("uniforms", (x64_sel, x64_acc), x64_swap),
                                   ("multi", multi_draws, None)):
                exchange64[(clab, nb, mode)] = exchange_vs_plain(
                    f"exchange float64{clab} n_beta={nb} {mode}", w64, c64, l64, bonds, unif, EXCHANGE_MISMATCH_MAX,
                    bool(clab), nb, sw if nb > 1 else None, f64_tols(c64))[:2]
    for wh in F64_EXCHANGE_WIDTHS:
        wham = HubbardChain(n_sites=WIDTH_N, n_up=4, n_down=4)
        wb = torch.as_tensor(wham.bonds, device=dev)
        for clab, wm in (("", RBM(n_inputs=WIDTH_N, n_hiddens=wh)),
                         (" with c", FFNN(n_inputs=WIDTH_N, n_hiddens=wh, dtype=torch.float32))):
            wwork = ffnn_work(wm) if clab else wm.make_work({k: PARAM_SCALE * v for k, v in wm.init_params(g).items()})
            w64c = widened(wwork, engine.full_forward(wwork, wham.init_spins(g, WIDTH_K))[0])
            for nb in (1, TEMPERED_NBETA):
                exchange64[(f" H={wh}{clab}", nb, "philox")] = exchange_vs_plain(
                    f"H={wh} exchange float64{clab} n_beta={nb} philox", *w64c, wb,
                    ExchangeDraws(philox_key(g), 2 * WIDTH_N), WIDTH_MISMATCH_MAX, bool(clab), nb, None,
                    f64_tols(w64c[1]))[:2]
    # the stress inputs on two rings of N/2 sites, two sweeps of N proposals, and at N = 16 for
    # F64_LONG_CASE a warm-up's launch of F64_LONG_SWEEPS sweeps: the state renewed from y after
    # every sweep, its drift bounded by one
    for case in F64_STRESS:
        for sn in F64_STRESS_N:
            for clab in ("", " with c"):
                w_, b_, a_, c_, s_ = f64_stress_inputs(case, bool(clab), seed=sn, n=sn, k=F64_STRESS_K)
                w64 = engine.Work(*(None if x is None else torch.as_tensor(x, device=dev) for x in (w_, b_, a_, c_)))
                c64_, l64_ = engine.full_forward(w64, torch.as_tensor(s_, device=dev))
                sb = torch.as_tensor(two_ring_bonds(sn // 2), device=dev)
                long_ = sn == F64_STRESS_N[0] and case == F64_LONG_CASE
                for sweeps in (2, F64_LONG_SWEEPS) if long_ else (2,):
                    exchange64[(f" {case}, N={sn}{clab}", 1, f"{sweeps} sweeps")] = exchange_vs_plain(
                        f"exchange float64 {case}, N={sn}{clab} {sweeps} sweeps in one launch", w64, c64_, l64_, sb,
                        ExchangeDraws(philox_key(g), sweeps * sn), F64_STRESS_NEAR_MAX, bool(clab), 1, None,
                        f64_tols(c64_), sn)[:2]
    # past the float64 kernels' range the sweep, exchange and energy wrappers raise and launch nothing
    w_, b_, a_, c_, s_ = f64_stress_inputs("Re w 25", False, seed=1, n=16, k=64)
    w64 = engine.Work(*(None if x is None else torch.as_tensor(x, device=dev) for x in (w_, b_, a_, c_)))
    w_past = w64._replace(w=w64.w + (engine.F64_MAX_RE_W + F64_PAST_RANGE - 25.0) * (w64.w.real == 25.0))
    c_past = engine.full_forward(w_past, torch.as_tensor(s_, device=dev))[0]
    past_counts = lambda: (sweep_cuda.launches_f64, exchange_cuda.launches_f64, offdiag_sum_cuda.launches_f64)  # noqa: E731
    before = past_counts()
    refused = []
    for name, call in (("sweep", lambda: sweep_cuda(w_past, c_past, torch.arange(16, dtype=torch.int32, device=dev),
                                                    PhiloxDraws(philox_key(g), 16))),
                       ("exchange", lambda: exchange_cuda(w_past, c_past, torch.as_tensor(two_ring_bonds(8), device=dev),
                                                          ExchangeDraws(philox_key(g), 16))),
                       ("energy", lambda: offdiag_sum_cuda(w_past, c_past))):
        try:
            call()
        except ValueError:
            refused.append(name)
    torch.cuda.synchronize()
    print(f"float64 weights at |Re w| = {engine.F64_MAX_RE_W + F64_PAST_RANGE} (past the range): refused by "
          f"{refused}; launches {past_counts()} against {before} before")
    if refused != ["sweep", "exchange", "energy"] or past_counts() != before:
        failures.append(f"float64 weights past the range: refused by {refused}, launches {past_counts()} / {before}")

    _enter("3c row0, probe and times", t0)
    # every sweep and exchange instance on its Philox stream at row0 = K/2,
    # as a walker mesh's shard launches (the counter's walker row offset by
    # the shard's first global row), against its plain version on the same
    # draws
    row0 = {}
    for clab, w_, c_, ln_ in (("", work, cache, lnpsi), (" with c", fwork, fcache, flnpsi)):
        for nb in (1, CHECK_NBETA):
            draws = PhiloxDraws(philox_key(g), N, row0=K // 2)
            ck, lk, _ = sweep_cuda(w_, c_, sched, draws, nb)
            cp, lp, _ = sweep_plain(w_, c_, ln_, sched, draws, nb)
            row0[("sweep", clab, nb)] = _compare(f"sweep{clab} philox row0={K // 2} n_beta={nb}", ck, lk, cp, lp,
                                                 SWEEP_MISMATCH_MAX, SWEEP_Y_ATOL, SWEEP_LNPSI_ATOL, failures,
                                                 cut=bool(clab))[:2]
            row0[("sweep_f64", clab, nb)] = sweep64_vs_plain(
                f"{clab} row0={K // 2} n_beta={nb}", *f64_cases[clab], sched, PhiloxDraws(philox_key(g), N, row0=K // 2),
                nb, SWEEP_MISMATCH_MAX)
    for clab, (w_, c_, ln_), w64c in (("", (hwork, hcache, hlnpsi), h64_cases[""]),
                                      (" with c", (hfwork, hfcache, hflnpsi), h64_cases[" with c"])):
        for nb in (1, TEMPERED_NBETA):
            xdraws = ExchangeDraws(philox_key(g), n_unit, row0=HUB_K // 2)
            row0[("exchange", clab, nb)] = exchange_vs_plain(
                f"exchange{clab} philox row0={HUB_K // 2} n_beta={nb}", w_, c_, ln_, bonds, xdraws,
                EXCHANGE_MISMATCH_MAX, bool(clab), nb)[:2]
            row0[("exchange_f64", clab, nb)] = exchange_vs_plain(
                f"exchange float64{clab} philox row0={HUB_K // 2} n_beta={nb}", *w64c, bonds, xdraws,
                EXCHANGE_MISMATCH_MAX, bool(clab), nb, None, f64_tols(w64c[1]))[:2]

    def row0_entry(name):
        """The row0 comparisons of kernel ``name``: mismatch share and
        largest ln psi error by instance."""
        return {f"{'c' if clab else 'rbm'} n_beta={nb}": {"mismatch_share": v[0], "max_abs_err": v[1]}
                for (kname, clab, nb), v in row0.items() if kname == name}

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
        # the sweep's and the exchange's float64 instances on the widened inputs
        "sweep_f64": (lambda: sweep_cuda(*f64_cases[""][:2], sched, philox_draws),
                      lambda: sweep_plain(*f64_cases[""], sched, philox_draws)),
        "sweep_f64_c": (lambda: sweep_cuda(*f64_cases[" with c"][:2], sched, philox_draws),
                        lambda: sweep_plain(*f64_cases[" with c"], sched, philox_draws)),
        "exchange_f64": (lambda: exchange_cuda(*h64_cases[""][:2], bonds, exchange_draws),
                         lambda: exchange_plain(*h64_cases[""], bonds, exchange_draws)),
        "exchange_f64_c": (lambda: exchange_cuda(*h64_cases[" with c"][:2], bonds, exchange_draws),
                           lambda: exchange_plain(*h64_cases[" with c"], bonds, exchange_draws)),
        "exchange_f64_tempered": (
            lambda: exchange_cuda(*h64_cases[""][:2], bonds, exchange_draws, n_beta=TEMPERED_NBETA, n_unit=n_unit),
            lambda: tempered_exchange_plain(*h64_cases[""], bonds, exchange_draws, None, TEMPERED_NBETA, n_unit)),
        "exchange_f64_tempered_c": (
            lambda: exchange_cuda(*h64_cases[" with c"][:2], bonds, exchange_draws, n_beta=TEMPERED_NBETA,
                                  n_unit=n_unit),
            lambda: tempered_exchange_plain(*h64_cases[" with c"], bonds, exchange_draws, None, TEMPERED_NBETA,
                                            n_unit)),
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
        "sweep_f64": lambda: sweep_cuda(*f64_cases[""][:2], sched, tempered_philox, CHECK_NBETA),
        "sweep_f64_c": lambda: sweep_cuda(*f64_cases[" with c"][:2], sched, tempered_philox, CHECK_NBETA),
    }
    timing = {name: (_time_ms(torch, fn, 20), _time_ms(torch, plain, 2)) for name, (fn, plain) in calls.items()}
    tempered_ms = {name: _time_ms(torch, fn, 20) for name, fn in tempered_calls.items()}
    uniform_ms = {name: _time_ms(torch, fn, 20) for name, fn in uniform_calls.items()}
    sweep_multi_ms = {name: _time_ms(torch, fn, 10) for name, fn in multi_calls.items()}
    # the float64 instance's table, which its wrapper builds on every call (as a
    # float64 energy step does: it widens the weights anew each step)
    f64_table_ms = {name: _time_ms(torch, lambda w=f64_cases[label][0]: engine.kernel_table_f64(w), 20)
                    for name, label in (("energy_f64", ""), ("energy_f64_c", " with c"))}
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
    for name, t_ms in f64_table_ms.items():
        print(f"{name}: its table (engine.kernel_table_f64) {t_ms:.4f} ms per call, in the wrapper's time")
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
    # the float64 RBM instance's own form: fewer operations than the bound counts
    energy_f64_form_floor = {"operations": 1e3 * K * N * h * F64_FORM_OPS / PEAK_F64_FLOPS,
                             "shared_memory": 1e3 * K * N * h * F64_FORM_SMEM_BYTES / PEAK_SMEM_BYTES_S}
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

    _enter("15b train driver", t0)
    # the train driver as a user runs it (python -m ...drivers.train): the
    # LITFI flagship warm-started from the recorded run, auto-saved every
    # DRIVER_NREC steps, then resumed; the same model in float64 at the N=64
    # anchor's walker count; the Hubbard trap chain in float64. Each run's
    # files go to the port's gitignored build directory.
    from neural_network_quantum_state_tpu_torch.drivers import train as train_driver

    run_root = build.BUILD_DIR / "train_driver"
    vmc_warm_up = VMC.warm_up
    shutil.rmtree(run_root, ignore_errors=True)
    _require(os.path.exists(DRIVER_RUN), f"{DRIVER_RUN} (the warm start) is missing from the checkout")
    flagship_argv = ["-model=LICH", "-ansatz=rbmtrsymm", "-L=64", "-nf=4", "-alpha=2.5", "-theta=2"]

    def drive_cli(label, sub, argv, want_steps, want):
        """One train.main run with the counts set to 0 just before; checks
        its steps, launches (``want``), plain calls and energies; prints its
        step ms, init + warm-up seconds and peak memory. Returns (result,
        metrics records of this run)."""
        path = run_root / sub
        path.mkdir(parents=True, exist_ok=True)
        if "-ifprefix=start" in argv:
            shutil.copyfile(DRIVER_RUN, path / "start")
        reset_counts()
        mem_base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        warmed = []  # when the driver's warm-up ended on the device (none on a resume)

        def warm_up(self, *args, **kwargs):
            out = vmc_warm_up(self, *args, **kwargs)
            torch.cuda.synchronize()
            warmed.append(time.perf_counter())
            return out

        VMC.warm_up = warm_up
        t_run = time.perf_counter()
        try:
            res = train_driver.main(argv + [f"-path={path}"])[0]
            torch.cuda.synchronize()
        finally:
            VMC.warm_up = vmc_warm_up
        wall = time.perf_counter() - t_run
        launches, plain_calls = read_counts()
        recs = [json.loads(line) for line in open(res["prefix"] + ".metrics.jsonl")][-len(res["history"]):]
        ts = [r["t"] for r in recs]
        steps = [hh["step"] for hh in res["history"]]
        energies = [hh["energy"] for hh in res["history"]]
        step_ms = [1e3 * (b_ - a_) for a_, b_ in zip(ts, ts[1:])]
        init = (f"init + warm-up {warmed[0] - t_run:.3f} s" if warmed else
                f"init + checkpoint load (no warm-up) {wall - ts[-1]:.3f} s, the final save included")
        print(f"train driver {label}: steps {steps[0]}..{steps[-1]}; step ms first {1e3 * ts[0]:.2f}, mean of the "
              f"rest {sum(step_ms) / max(1, len(step_ms)):.2f}; {init}; wall {wall:.3f} s; peak memory above the "
              f"{mem_base / 2**20:.1f} MiB held before {(torch.cuda.max_memory_allocated() - mem_base) / 2**20:.1f} MiB; "
              f"last energies {energies[-3:]}")
        print(f"train driver {label}: launches {launches}; plain-version calls: {plain_calls}")
        _require(steps == list(want_steps), f"train driver {label}: steps {steps}")
        _require(all(math.isfinite(e) for e in energies), f"train driver {label}: energies {energies}")
        _require(plain_calls == 0, f"train driver {label}: the path called a plain version {plain_calls} times")
        _require(launches == want, f"train driver {label}: launches {launches}, expected {want}")
        text = {"RBM": "Dw.dat", "FFNN": "Dw1.dat"}.get(type(res["machine"]).__name__, "")  # the text checkpoint
        state = ".orbax" if "-ckpt=orbax" in argv else ".state.npz"  # the structured state, per -ckpt
        for suffix in (text, state, ".metrics.jsonl"):
            _require(os.path.exists(res["prefix"] + suffix), f"train driver {label}: {res['prefix']}{suffix} missing")
        path_launches[f"train driver {label}"] = launches
        return res, recs

    res, _ = drive_cli("LITFI float32", "f32", flagship_argv + [
        f"-ns={K}", f"-nwarm={DRIVER_WARM}", f"-niter={DRIVER_STEPS}", f"-nrec={DRIVER_NREC}", "-ifprefix=start"],
        range(DRIVER_STEPS), expect(sweep=1 + DRIVER_STEPS, energy=DRIVER_STEPS))
    _require(os.path.basename(res["prefix"]) == os.path.basename(DRIVER_RUN), f"train driver: prefix {res['prefix']}")
    _, recs = drive_cli("LITFI float32 resumed", "f32", flagship_argv + [
        f"-ns={K}", f"-niter={DRIVER_RESUME_STEPS}", f"-resume={os.path.basename(DRIVER_RUN)}"],
        range(DRIVER_STEPS, DRIVER_STEPS + DRIVER_RESUME_STEPS),
        expect(sweep=DRIVER_RESUME_STEPS, energy=DRIVER_RESUME_STEPS))
    lam_resumed = recs[0]["lam"]
    print(f"train driver: lambda at step {DRIVER_STEPS} after the resume {lam_resumed} "
          f"(100 * 0.9^{DRIVER_STEPS + 1} = {100.0 * 0.9 ** (DRIVER_STEPS + 1)})")
    _require(abs(lam_resumed - 100.0 * 0.9 ** (DRIVER_STEPS + 1)) < 1e-3, f"train driver: lambda {lam_resumed}")

    # the Orbax arm: the flagship saved as .orbax and resumed from it, then
    # the JAX package's -ckpt=orbax runs resumed; every save and load timed
    # on the host (the driver's own calls, wrapped)
    from neural_network_quantum_state_tpu_torch.utils import checkpoint as ckpt

    orbax_io = {"save": [], "load": []}
    driver_io = (train_driver.save_orbax, train_driver.load_orbax)

    def timed(kind, fn):
        def wrapped(*args, **kwargs):
            t_io = time.perf_counter()
            out = fn(*args, **kwargs)
            orbax_io[kind].append(time.perf_counter() - t_io)
            return out
        return wrapped

    train_driver.save_orbax, train_driver.load_orbax = timed("save", ckpt.save_orbax), timed("load", ckpt.load_orbax)
    try:
        res, _ = drive_cli("LITFI float32 -ckpt=orbax", "f32_orbax", flagship_argv + [
            f"-ns={K}", f"-nwarm={DRIVER_WARM}", f"-niter={DRIVER_STEPS}", f"-nrec={DRIVER_NREC}", "-ifprefix=start",
            "-ckpt=orbax"], range(DRIVER_STEPS), expect(sweep=1 + DRIVER_STEPS, energy=DRIVER_STEPS))
        _require(os.path.isdir(res["prefix"] + ".orbax") and not os.path.exists(res["prefix"] + ".state.npz"),
                 "train driver -ckpt=orbax: expected the .orbax directory and no .state.npz")
        flag_saves = list(orbax_io["save"])
        _, recs = drive_cli("LITFI float32 -ckpt=orbax resumed", "f32_orbax", flagship_argv + [
            f"-ns={K}", f"-niter={DRIVER_RESUME_STEPS}", "-ckpt=orbax", f"-resume={os.path.basename(DRIVER_RUN)}"],
            range(DRIVER_STEPS, DRIVER_STEPS + DRIVER_RESUME_STEPS),
            expect(sweep=DRIVER_RESUME_STEPS, energy=DRIVER_RESUME_STEPS))
        _require(len(orbax_io["load"]) == 1, f"train driver -ckpt=orbax: {len(orbax_io['load'])} loads of .orbax")
        lam_orbax = recs[0]["lam"]
        print(f"train driver -ckpt=orbax: lambda at step {DRIVER_STEPS} after the resume {lam_orbax}; host seconds "
              f"of the flagship's saves (8192 x 64 walkers) {[round(x, 4) for x in flag_saves]}, of its load "
              f"{orbax_io['load'][0]:.4f}")
        _require(abs(lam_orbax - 100.0 * 0.9 ** (DRIVER_STEPS + 1)) < 1e-3,
                 f"train driver -ckpt=orbax: lambda {lam_orbax}")
        # the JAX package's runs: read onto the card with no JAX, then resumed
        fixture_m = RBMTrSymm(n_inputs=16, alpha=2, dtype=torch.float32)
        for run in ("one", "mesh4"):
            src = os.path.join(JAX_ORBAX_FIXTURES, run)
            _require(os.path.isdir(os.path.join(src, JAX_ORBAX_PREFIX + ".orbax")),
                     f"{src}/{JAX_ORBAX_PREFIX}.orbax is missing from the checkout")
            t_io = time.perf_counter()
            fparams, fstep, fgen, fspins, _ = ckpt.load_orbax(os.path.join(src, JAX_ORBAX_PREFIX + ".orbax"), fixture_m,
                                                              device="cuda")
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t_io
            text = ckpt.load_reference_text(fixture_m, os.path.join(src, JAX_ORBAX_PREFIX), device="cuda")
            rel = max(float(((fparams[k] - text[k]).abs() / text[k].abs().clamp_min(1e-30)).max()) for k in text)
            print(f"JAX -ckpt=orbax run {run}: decoded in {decode_s:.4f} s on the host; step {fstep}; walkers "
                  f"{tuple(fspins.shape)}; params against the text checkpoint: largest relative difference {rel:.3e}")
            _require(fstep == JAX_ORBAX_STEP and fgen is not None and fspins.is_cuda, f"JAX orbax {run}: step {fstep}")
            _require(bool(((fspins == 1) | (fspins == -1)).all()), f"JAX orbax {run}: walkers not +-1")
            _require(rel <= JAX_ORBAX_TEXT_RTOL, f"JAX orbax {run}: params off the text checkpoint by {rel:.3e}")
            dst = run_root / f"jax_orbax_{run}"
            shutil.copytree(os.path.join(src, JAX_ORBAX_PREFIX + ".orbax"), dst / (JAX_ORBAX_PREFIX + ".orbax"))
            drive_cli(f"JAX -ckpt=orbax run {run} resumed", f"jax_orbax_{run}", JAX_ORBAX_ARGV + [
                f"-niter={JAX_ORBAX_STEPS}", "-ckpt=orbax", f"-resume={JAX_ORBAX_PREFIX}"],
                range(JAX_ORBAX_STEP, JAX_ORBAX_STEP + JAX_ORBAX_STEPS),
                expect(sweep=JAX_ORBAX_STEPS, energy=JAX_ORBAX_STEPS))
    finally:
        train_driver.save_orbax, train_driver.load_orbax = driver_io

    drive_cli("LITFI float64", "f64", flagship_argv + [
        "-dtype=float64", f"-ns={DRIVER_F64_K}", f"-nwarm={DRIVER_F64_WARM}", f"-niter={DRIVER_F64_STEPS}",
        "-ifprefix=start"], range(DRIVER_F64_STEPS),
        expect(sweep_f64=1 + DRIVER_F64_STEPS, energy_f64=DRIVER_F64_STEPS))
    res, _ = drive_cli("Hubbard float64", "hubbard", [
        "-model=hubbard", "-ansatz=rbm", f"-L={HUB_L}", f"-nf={HUB_H}", f"-npar={HUB_PARTICLES},{HUB_PARTICLES}",
        f"-trap={HUB_TRAP}", f"-ns={HUB_K}", "-dtype=float64", f"-nwarm={DRIVER_HUB_WARM}",
        f"-niter={DRIVER_HUB_STEPS}"], range(DRIVER_HUB_STEPS), expect(exchange_f64=1 + DRIVER_HUB_STEPS))
    with np.load(res["prefix"] + ".state.npz") as saved:
        _require(sector_ok(torch.as_tensor(saved["__spins__"])), "train driver Hubbard float64: a walker left its sector")
    # the same two float64 models tempered (-nbeta=4): the ladder in the
    # float64 sweep's and exchange's tempered instances
    drive_cli("LITFI float64 tempered", "f64_tempered", flagship_argv + [
        "-dtype=float64", f"-ns={DRIVER_F64_K}", f"-nwarm={DRIVER_TEMPERED_WARM}", f"-niter={DRIVER_TEMPERED_STEPS}",
        f"-nbeta={TEMPERED_NBETA}"], range(DRIVER_TEMPERED_STEPS),
        expect(sweep_f64=1 + DRIVER_TEMPERED_STEPS, energy_f64=DRIVER_TEMPERED_STEPS))
    res, _ = drive_cli("Hubbard float64 tempered", "hubbard_tempered", [
        "-model=hubbard", "-ansatz=rbm", f"-L={HUB_L}", f"-nf={HUB_H}", f"-npar={HUB_PARTICLES},{HUB_PARTICLES}",
        f"-trap={HUB_TRAP}", f"-ns={HUB_K}", "-dtype=float64", f"-nwarm={DRIVER_TEMPERED_WARM}",
        f"-niter={DRIVER_TEMPERED_STEPS}", f"-nbeta={TEMPERED_NBETA}"], range(DRIVER_TEMPERED_STEPS),
        expect(exchange_f64=1 + DRIVER_TEMPERED_STEPS, exchange_f64_tempered=1 + DRIVER_TEMPERED_STEPS))
    with np.load(res["prefix"] + ".state.npz") as saved:
        _require(sector_ok(torch.as_tensor(saved["__spins__"])),
                 "train driver Hubbard float64 tempered: a replica left its sector")

    _enter("15c measure driver", t0)
    # the measure driver as a user runs it (python -m ...drivers.measure),
    # each run on a copy of its checkpoint under the build directory (the
    # driver writes next to -prefix; runs/ holds the anchors), the counts set
    # to 0 just before each run: its launches, plain calls, wall seconds,
    # iterations/s and peak memory, its printed result lines
    import contextlib
    import io

    from neural_network_quantum_state_tpu_torch.drivers import measure as measure_driver
    from neural_network_quantum_state_tpu_torch.measurements import fermion as fermion_meas

    meas_root = build.BUILD_DIR / "measure_driver"
    shutil.rmtree(meas_root, ignore_errors=True)
    meas_root.mkdir(parents=True)
    meas_results = {}

    def copy_run(src: str) -> str:
        """Copy a recorded checkpoint's text files (the symmetric machines'
        one file, an RBM's Dw/Da/Db.dat) under meas_root; returns the copy's prefix."""
        dst = str(meas_root / os.path.basename(src))
        copied = [sfx for sfx in ("", "Dw.dat", "Da.dat", "Db.dat") if os.path.isfile(src + sfx)]
        _require(bool(copied), f"{src} (a measured checkpoint) is missing from the checkout")
        for sfx in copied:
            shutil.copyfile(src + sfx, dst + sfx)
        return dst

    def drive_measure(label, argv, want, iterations):
        """One measure.main run with the counts set to 0 just before; checks
        its launches (``want``) and plain calls; prints its result lines,
        wall s, iterations/s and peak MiB; returns (result, printed text)."""
        reset_counts()
        torch.cuda.synchronize()
        mem_base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = io.StringIO()
        t_run = time.perf_counter()
        with contextlib.redirect_stdout(out):
            res = measure_driver.main(argv)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
        launches, plain_calls = read_counts()
        text = out.getvalue()
        lines = [ln for ln in text.splitlines() if not re.match(r"# \w+ = ", ln)]
        peak = (torch.cuda.max_memory_allocated() - mem_base) / 2**20
        for ln in lines[-3:]:
            print(f"measure {label}: {ln}")
        print(f"measure {label}: wall {wall:.3f} s, {iterations} iterations, {iterations / wall:.1f} iterations/s, "
              f"peak memory above the {mem_base / 2**20:.1f} MiB held before {peak:.1f} MiB; launches {launches}; "
              f"plain-version calls: {plain_calls}")
        _require(plain_calls == 0, f"measure {label}: the path called a plain version {plain_calls} times")
        _require(launches == want, f"measure {label}: launches {launches}, expected {want}")
        meas_results[label] = {"wall_s": wall, "iterations": iterations, "iterations_per_s": iterations / wall,
                               "peak_mib": peak, "launches": {k_: v for k_, v in launches.items() if v}}
        path_launches[f"measure {label}"] = launches
        return res, text

    # (a) the Binder production run: the sweep kernel's n_beta = 8 instance,
    # one launch for the warm-up and one per iteration
    binder_argv = ["-what=stag", "-ansatz=rbmtrsymm", "-L=64", "-nf=4", "-ns=8192", "-niter=300", "-nms=3",
                   "-nwarm=500", "-nbeta=8", "-fused=1", "-seed=21"]
    binder_prefix = copy_run(MEAS_BINDER_RUN)
    (m1, m2, m4), text = drive_measure("binder", binder_argv + [f"-prefix={binder_prefix}"], expect(sweep=1 + 300), 300)
    _require(0.0 <= m1 * m1 <= m2 <= 1.0 and m4 <= m2, f"measure binder: moments {m1}, {m2}, {m4}")
    grep = re.findall(r"binder=[0-9.-]*", text)  # the campaign script's grep
    _require(len(grep) == 1 and math.isfinite(float(grep[0].split("=")[1])), f"measure binder: grep {grep}")

    # (b) the L=32 Hubbard trap at the recorded depth: energy, density, OPDM (at half of it)
    hub_argv = ["-model=hubbard", "-U=4", "-t=1", f"-trap={HUB_TRAP}", "-ansatz=rbm", f"-L={2 * HUB_L}",
                f"-nf={HUB_H}", f"-ns={HUB_K}", f"-npar={HUB_PARTICLES},{HUB_PARTICLES}", "-nms=3", "-fused=1"]
    hub_prefix = copy_run(MEAS_HUB_RUN)
    recorded_density = np.loadtxt(MEAS_HUB_RUN + ".density.dat")
    recorded_opdm = np.loadtxt(MEAS_HUB_RUN + ".opdm16.dat")
    full = ["-nwarm=5000", "-niter=300", f"-prefix={hub_prefix}"]
    (e_hub, e_err), _ = drive_measure("Hubbard energy", hub_argv + full + ["-what=energy", "-seed=3"],
                                      expect(exchange=1 + 300), 300)
    print(f"measure Hubbard energy: {e_hub.real:+.7f} +/- {e_err:.2e}, recorded {MEAS_HUB_ENERGY} "
          f"(difference {e_hub.real - MEAS_HUB_ENERGY:+.2e}, bar {MEAS_HUB_ENERGY_TOL})")
    _require(abs(e_hub.real - MEAS_HUB_ENERGY) < MEAS_HUB_ENERGY_TOL, f"measure Hubbard energy {e_hub}")
    occ, _ = drive_measure("Hubbard density", hub_argv + full + ["-what=density", "-seed=4"],
                           expect(exchange=1 + 300), 300)
    d_err = float(np.abs(np.c_[occ[:HUB_L], occ[HUB_L:]] - recorded_density).max())
    print(f"measure Hubbard density: sum n = {occ.sum():.6f}; max |n - recorded| {d_err:.4f} (bar {MEAS_DENSITY_TOL})")
    _require(abs(occ.sum() - MEAS_SUM_N) < MEAS_SUM_TOL and d_err < MEAS_DENSITY_TOL, "measure Hubbard density")
    opdm = ["-nwarm=5000", f"-niter={MEAS_OPDM_ITERS}", f"-prefix={hub_prefix}"]
    row, _ = drive_measure("Hubbard OPDM", hub_argv + opdm + ["-what=opdm", "-site=16", "-seed=5"],
                           expect(exchange=1 + 16 * MEAS_OPDM_ITERS), 16 * MEAS_OPDM_ITERS)
    o_err = max(abs(row[m].real - recorded_opdm[m, 0]) for m in (0, 1))
    print(f"measure Hubbard OPDM: (16,16) {row[0].real:.6f}, (16,17) {row[1].real:.6f}, recorded "
          f"{recorded_opdm[0, 0]:.6f}, {recorded_opdm[1, 0]:.6f}; max difference {o_err:.5f} (bar {MEAS_OPDM_TOL})")
    _require(o_err < MEAS_OPDM_TOL and all(math.isfinite(abs(v)) for v in row), "measure Hubbard OPDM")
    # ... then tempered (-nbeta=4), cut depth: the exchange kernel's tempered instance
    samplers = []
    fermion_sampler = measure_driver.FermionAmplitudeSampler

    class Recorded(fermion_sampler):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            samplers.append(self)

    measure_driver.FermionAmplitudeSampler = Recorded
    try:
        occ_t, _ = drive_measure("Hubbard density tempered", hub_argv + [
            f"-nwarm={MEAS_TEMPERED_WARM}", f"-niter={MEAS_TEMPERED_ITERS}", f"-prefix={hub_prefix}",
            "-what=density", "-nbeta=4", "-fused=0", "-seed=4"],
            expect(exchange=1 + MEAS_TEMPERED_ITERS, exchange_tempered=1 + MEAS_TEMPERED_ITERS), MEAS_TEMPERED_ITERS)
    finally:
        measure_driver.FermionAmplitudeSampler = fermion_sampler
    _require(len(samplers) == 1 and samplers[0].n_beta == 4 and sector_ok(samplers[0].state.cache.spins)
             and abs(occ_t.sum() - MEAS_SUM_N) < MEAS_SUM_TOL, "measure Hubbard density tempered: sectors")
    print(f"measure Hubbard density tempered: every replica of the {HUB_K // 4} chains x 4 in its sector, "
          f"sum n = {occ_t.sum():.6f}")

    # (c) the deep-ordered Renyi run (plain PyTorch glued sweeps: no kernel)
    renyi_prefix = copy_run(MEAS_RENYI_RUN)
    (s2, s2_err), _ = drive_measure("Renyi increment", [
        "-what=renyi_inc", "-ansatz=rbmtrsymm", "-L=64", "-nf=4", "-l=32", "-l0=0", "-z2q=1", "-ns=256",
        f"-niter={MEAS_RENYI_ITERS}", "-nms=2", f"-nwarm={MEAS_RENYI_WARM}", "-init=neel", "-seed=41", "-mchunk=25",
        f"-prefix={renyi_prefix}"], expect(), MEAS_RENYI_ITERS)
    print(f"measure Renyi increment: S2 {s2:.6f} +/- {s2_err:.2e}, ln 2 = {math.log(2):.6f} "
          f"(difference {s2 - math.log(2):+.2e}, bar {MEAS_RENYI_TOL})")
    _require(abs(s2 - math.log(2)) < MEAS_RENYI_TOL, f"measure Renyi increment: S2 {s2}")

    # (d) the other modes at full width and small depth on the flagship
    flag_prefix, flag2_prefix = copy_run(MEAS_FLAGSHIP), copy_run(MEAS_FLAGSHIP2)
    spin_argv = ["-ansatz=rbmtrsymm", "-L=64", "-nf=4", "-ns=8192", f"-nwarm={MEAS_SMALL_WARM}", "-nms=1",
                 f"-prefix={flag_prefix}", f"-prefix2={flag2_prefix}"]
    one = 1 + MEAS_SMALL_ITERS  # a sampler's warm-up and iterations
    small = [f"-niter={MEAS_SMALL_ITERS}"]
    modes = [
        ("energy", ["-what=energy", "-model=LICH", "-theta=2", "-alpha=2.5"] + small,
         expect(sweep=one, energy=MEAS_SMALL_ITERS)),
        ("renyi", ["-what=renyi", "-l=32"] + small, expect(sweep=2 * one)),
        ("fidelity", ["-what=fidelity"] + small, expect(sweep=2 * one)),
        ("overlap", ["-what=overlap"] + small, expect(sweep=one)),
        ("smag", ["-what=smag"] + small, expect(sweep=one)),
        ("corrratio", ["-what=corrratio"] + small, expect(sweep=one)),
        ("zz", ["-what=zz"] + small, expect(sweep=one)),
        ("xx", ["-what=xx", f"-niter={MEAS_XX_ITERS}"], expect(sweep=1 + MEAS_XX_ITERS)),
        ("neel", ["-what=neel"] + small, expect(sweep=one)),
        ("smag float64", ["-what=smag", "-dtype=float64", f"-ns={MEAS_F64_K}"] + small, expect(sweep_f64=one)),
    ]
    for label, extra, want in modes:
        iters = MEAS_XX_ITERS if label == "xx" else MEAS_SMALL_ITERS
        res, _ = drive_measure(label, spin_argv + extra, want, iters)
        flat = np.concatenate([np.ravel(np.asarray(v, dtype=complex)) for v in (res if isinstance(res, tuple) else (res,))])
        _require(bool(np.isfinite(flat).all()), f"measure {label}: {res}")
    for sfx in (".zz.dat", ".x.dat", ".xx.dat"):
        _require(np.loadtxt(flag_prefix + sfx).shape[0] == N, f"measure: {flag_prefix}{sfx}")

    # (e) N = 16 estimators against exact enumeration on the card, n_beta = 1 and 4
    for nb in (1, TEMPERED_NBETA):
        reset_counts()
        t_run = time.perf_counter()
        exact = _exact_estimators(dev, nb)
        torch.cuda.synchronize()
        launches, plain_calls = read_counts()
        errs_e = {}
        for name, (got_v, want_v, tol) in exact.items():
            errs_e[name] = float(np.max(np.abs(np.asarray(got_v) - np.asarray(want_v))))
            _require(errs_e[name] < tol, f"measure exact n_beta={nb}: {name} off by {errs_e[name]:.3e} (tol {tol:.3e})")
        print(f"measure exact N={EXACT_N} n_beta={nb}: max |estimate - exact| "
              + ", ".join(f"{k} {v:.2e} (tol {exact[k][2]:.2e})" for k, v in errs_e.items())
              + f"; {time.perf_counter() - t_run:.1f} s; launches {launches}; plain-version calls: {plain_calls}")
        _require(plain_calls == 0 and launches["sweep"] > 0, f"measure exact n_beta={nb}: launches {launches}")
        meas_results[f"exact N={EXACT_N} n_beta={nb}"] = {"max_abs_err": errs_e, "tolerance": {
            k: v[2] for k, v in exact.items()}}

    _enter("15d mesh", t0)

    def mesh_phase():
        """Phase 15d in a scope of its own (its names must not replace
        those that later phases read); returns its results."""
        # the walker mesh (parallel/mesh.py) through the user's entry points:
        # MESH_SHARDS shards on this one card, each sampler call one launch per
        # shard on the call's one Philox key (each shard at its first global
        # walker row), each step's local energy one launch per shard, the SR sums
        # reduced over the shards; held to one device with the same seed
        from neural_network_quantum_state_tpu_torch.api import sampler as api_sampler
        from neural_network_quantum_state_tpu_torch.parallel import gather, make_mesh, make_mesh_2d, make_mesh_tp

        mesh_results = {}
        mesh4 = make_mesh(MESH_SHARDS)
        litfi_ham = LITFIChain(n_sites=N, h=-0.5, j=0.866, alpha=2.5, pbc=True)

        def litfi_vmc(mesh, n_beta=1):
            return VMC(RBMTrSymm(n_inputs=N, alpha=ALPHA, dtype=torch.float32), litfi_ham,
                       VMCConfig(n_walkers=K, learning_rate=1e-2, solver="cg", use_fused_sweeps=True, n_beta=n_beta,
                                 seed=3), mesh=mesh)

        def hubbard_vmc(mesh, n_beta=1):
            return VMC(RBM(n_inputs=2 * HUB_L, n_hiddens=HUB_H, dtype=torch.float32), hubbard,
                       VMCConfig(n_walkers=HUB_K, learning_rate=1e-2, solver="cg", n_beta=n_beta, seed=11), mesh=mesh)

        def mesh_run(label, vmc, n_warm, n_steps, want):
            """init, one warm-up call and n_steps SR steps with the counts set to
            0 just before; checks the launches (``want``) and that no plain
            version ran; returns (warm-up spins gathered, final state, energies,
            mean step ms after the first)."""
            reset_counts()
            t_run = time.perf_counter()
            params, state = vmc.init()
            warm = vmc.warm_up(params, state, n_warm)
            torch.cuda.synchronize()
            t_warm = time.perf_counter() - t_run
            stamps = [time.perf_counter()]
            _, state, hist, _ = vmc.run(params, warm, n_steps, callback=lambda i, st: stamps.append(time.perf_counter()))
            torch.cuda.synchronize()
            launches, plain_calls = read_counts()
            steps_ms = [1e3 * (b_ - a_) for a_, b_ in zip(stamps, stamps[1:])]
            mean_ms = sum(steps_ms[1:]) / max(1, len(steps_ms) - 1)
            energies = [r["energy"] for r in hist]
            print(f"mesh {label}: init + warm-up {t_warm:.3f} s; step ms first {steps_ms[0]:.2f}, mean of the rest "
                  f"{mean_ms:.2f}; energies {energies[:3]}..{energies[-1:]}; launches {launches}; "
                  f"plain-version calls: {plain_calls}")
            _require(len(hist) == n_steps and all(math.isfinite(e) for e in energies), f"mesh {label}: energies {energies}")
            _require(plain_calls == 0, f"mesh {label}: a plain version ran {plain_calls} times")
            _require(launches == want, f"mesh {label}: launches {launches}, expected {want}")
            path_launches[label if vmc.mesh is None else f"mesh {label}"] = launches
            mesh_results[label] = {"step_ms": mean_ms, "first_step_ms": steps_ms[0], "warm_s": t_warm,
                                   "launches": {k_: v_ for k_, v_ in launches.items() if v_}}
            return gather(warm.cache.spins), state, energies, mean_ms

        # (a) the flagship on one device and on 4 shards, the same seed
        s = MESH_SHARDS
        one_warm, _, one_e, one_ms = mesh_run("LITFI one device", litfi_vmc(None), WARM_SWEEPS, MESH_STEPS,
                                              expect(sweep=1 + MESH_STEPS, energy=MESH_STEPS))
        m_warm, _, m_e, m_ms = mesh_run(f"LITFI {s} shards", litfi_vmc(mesh4), WARM_SWEEPS, MESH_STEPS,
                                        expect(sweep=s * (1 + MESH_STEPS), energy=s * MESH_STEPS))
        rel0 = abs(m_e[0] - one_e[0]) / abs(one_e[0])
        print(f"mesh LITFI: warm-up spins equal to one device's: {torch.equal(m_warm, one_warm)}; step-0 energy "
              f"rel. difference {rel0:.3e} (tol {MESH_E0_RTOL:.0e}); all steps' largest rel. difference "
              f"{max(abs(a_ - b_) / abs(b_) for a_, b_ in zip(m_e, one_e)):.3e}; step ms {m_ms:.2f} on {s} shards "
              f"against {one_ms:.2f} on one device")
        _require(torch.equal(m_warm, one_warm), "mesh LITFI: the warm-up spins differ from one device's")
        _require(rel0 <= MESH_E0_RTOL, f"mesh LITFI: step-0 energy off by {rel0:.3e}")
        mesh_results["LITFI"] = {"warm_spins_equal": True, "step0_rel_diff": rel0, "step_ms_mesh": m_ms,
                                 "step_ms_one_device": one_ms}

        # (b) the trap on 4 shards, every shard in its sector; both tempered flagships on 4 shards
        _, h_state, _, _ = mesh_run(f"Hubbard {s} shards", hubbard_vmc(mesh4), HUB_WARM_SWEEPS, MESH_HUB_STEPS,
                                    expect(exchange=s * (1 + MESH_HUB_STEPS)))
        _require(all(sector_ok(p_) for p_ in h_state.cache.spins), "mesh Hubbard: a shard's walker left its sector")
        mesh_run(f"tempered LITFI {s} shards", litfi_vmc(mesh4, TEMPERED_NBETA), WARM_SWEEPS, MESH_TEMPERED_STEPS,
                 expect(sweep=s * (1 + MESH_TEMPERED_STEPS), energy=s * MESH_TEMPERED_STEPS))
        _, th_state, _, _ = mesh_run(f"tempered Hubbard {s} shards", hubbard_vmc(mesh4, TEMPERED_NBETA), MESH_HUB_WARM,
                                     MESH_TEMPERED_STEPS, expect(exchange=s * (1 + MESH_TEMPERED_STEPS),
                                                                 exchange_tempered=s * (1 + MESH_TEMPERED_STEPS)))
        _require(all(sector_ok(p_) for p_ in th_state.cache.spins), "mesh tempered Hubbard: a replica left its sector")
        print(f"mesh Hubbard: every shard's walkers in the {HUB_PARTICLES}+{HUB_PARTICLES} sector, tempered too")

        # (c) the 2D and TP layouts of the same 4 devices against the 1D mesh
        for label, mesh in (("2D (2, 2)", make_mesh_2d(2, 2)), ("TP (2, 2)", make_mesh_tp(2, 2))):
            _, _, e_, _ = mesh_run(label, litfi_vmc(mesh), WARM_SWEEPS, MESH_LAYOUT_STEPS,
                                   expect(sweep=s * (1 + MESH_LAYOUT_STEPS), energy=s * MESH_LAYOUT_STEPS))
            diff = max(abs(a_ - b_) / abs(b_) for a_, b_ in zip(e_, m_e))
            print(f"mesh {label}: energies' largest rel. difference from the 1D mesh {diff:.3e} (tol {MESH_E0_RTOL:.0e})")
            _require(diff <= MESH_E0_RTOL, f"mesh {label}: energies off the 1D mesh's by {diff:.3e}")
            mesh_results[label]["rel_diff_1d"] = diff

        # (d) the drivers: -mesh=4 warm-started and resumed, -gridmesh=2 on two
        # thetas (two threads, each on a 2-shard submesh of the card), float64 on
        # 2 shards; the measure driver on 4 shards
        drive_cli(f"LITFI float32 -mesh={s}", "mesh", flagship_argv + [
            f"-ns={K}", f"-nwarm={DRIVER_WARM}", f"-niter={DRIVER_STEPS}", f"-nrec={DRIVER_NREC}", "-ifprefix=start",
            f"-mesh={s}"], range(DRIVER_STEPS), expect(sweep=s * (1 + DRIVER_STEPS), energy=s * DRIVER_STEPS))
        drive_cli(f"LITFI float32 -mesh={s} resumed", "mesh", flagship_argv + [
            f"-ns={K}", f"-niter={DRIVER_RESUME_STEPS}", f"-resume={os.path.basename(DRIVER_RUN)}", f"-mesh={s}"],
            range(DRIVER_STEPS, DRIVER_STEPS + DRIVER_RESUME_STEPS),
            expect(sweep=s * DRIVER_RESUME_STEPS, energy=s * DRIVER_RESUME_STEPS))
        drive_cli("LITFI float64 -mesh=2", "mesh_f64", flagship_argv + [
            "-dtype=float64", f"-ns={DRIVER_F64_K}", f"-nwarm={DRIVER_TEMPERED_WARM}", f"-niter={DRIVER_TEMPERED_STEPS}",
            "-mesh=2"], range(DRIVER_TEMPERED_STEPS),
            expect(sweep_f64=2 * (1 + DRIVER_TEMPERED_STEPS), energy_f64=2 * DRIVER_TEMPERED_STEPS))
        grid_path = run_root / "gridmesh"
        grid_path.mkdir(parents=True, exist_ok=True)
        reset_counts()
        t_run = time.perf_counter()
        grid = train_driver.main(["-model=LICH", "-ansatz=rbmtrsymm", "-L=64", "-nf=4", "-alpha=2.5", "-theta=1.8,2.2",
                                  f"-ns={DRIVER_F64_K}", f"-nwarm={DRIVER_TEMPERED_WARM}", f"-niter={MESH_GRID_STEPS}",
                                  "-gridmesh=2", f"-path={grid_path}"])
        torch.cuda.synchronize()
        launches, plain_calls = read_counts()
        grid_e = [r_["history"][-1]["energy"] for r_ in grid]
        print(f"train driver -gridmesh=2 (two thetas at once, 2 shards each): {time.perf_counter() - t_run:.3f} s; "
              f"last energies {grid_e}; launches {launches}; plain-version calls: {plain_calls}")
        _require(len({r_["prefix"] for r_ in grid}) == 2 and all(os.path.exists(r_["prefix"]) for r_ in grid),
                 f"-gridmesh: checkpoints {[r_['prefix'] for r_ in grid]}")
        _require(all(math.isfinite(e_) for e_ in grid_e) and plain_calls == 0 and launches["sweep"] > 0
                 and launches["energy"] > 0, f"-gridmesh: energies {grid_e}, launches {launches}, plain {plain_calls}")
        path_launches["train driver -gridmesh=2"] = launches
        flagship_copy = copy_run(MEAS_FLAGSHIP)
        _, text = drive_measure(f"stag -mesh={s}", [
            "-what=stag", "-ansatz=rbmtrsymm", "-L=64", "-nf=4", f"-ns={K}", f"-niter={MEAS_SMALL_ITERS}", "-nms=1",
            f"-nwarm={MEAS_SMALL_WARM}", f"-prefix={flagship_copy}", f"-mesh={s}"],
            expect(sweep=s * (1 + MEAS_SMALL_ITERS)), MEAS_SMALL_ITERS)

        # (e) the pynqs-style API on a copy of the flagship checkpoint
        reset_counts()
        rbm = api_sampler.RBM(floatType="float32", symmType="tr")
        rbm.init(nInputs=N, nHiddens=ALPHA, nChains=K, seedNumber=7, seedDistance=1, path_to_load=flagship_copy,
                 init_mcmc_steps=MESH_API_WARM)
        for _ in range(MESH_API_CALLS):
            rbm.do_mcmc_steps(2)
        ln_api = rbm.get_lnpsi()
        ln_fixed = rbm.get_lnpsi_for_fixed_spins(rbm.get_spinStates())
        launches, plain_calls = read_counts()
        api_err = float(np.max(np.abs(ln_fixed - ln_api)))
        print(f"API RBM(tr) on the flagship checkpoint: |get_lnpsi - get_lnpsi_for_fixed_spins| {api_err:.3e} "
              f"(tol {MESH_API_ATOL:.0e}); launches {launches}; plain-version calls: {plain_calls}")
        _require(api_err <= MESH_API_ATOL and ln_api.shape == (K,), f"API: ln psi off by {api_err:.3e}")
        _require(launches == expect(sweep=1 + MESH_API_CALLS) and plain_calls == 0, f"API: launches {launches}")
        path_launches["API sampler"] = launches
        mesh_results["API"] = {"max_abs_err": api_err, "launches": launches["sweep"]}
        print(f"mesh: {json.dumps(mesh_results)}")
        return mesh_results

    mesh_results = mesh_phase()

    _enter("15e precision anchor", t0)
    # the paper's accuracy anchor at full protocol (examples/precision_anchor.py):
    # the port's ED on the host, then RBMTrSymm(20, alpha 4), K = 8192, 500
    # warm-up sweeps and 8000 mixed-precision SR steps on the card
    anchor_dir = str(build.BUILD_DIR / "precision_anchor")
    os.makedirs(anchor_dir, exist_ok=True)
    jax_anchor = precision_anchor.recorded(ANCHOR_N)
    _require(jax_anchor is not None and "rel_err" in jax_anchor,
             f"precision anchor: no JAX record logs/precision_anchor_{{ed,vmc}}_N{ANCHOR_N}.json")
    t_ed = time.perf_counter()
    anchor_e0 = precision_anchor.run_ed(ANCHOR_N, anchor_dir)
    anchor_ed_s = time.perf_counter() - t_ed
    e0_rel = abs(anchor_e0 - jax_anchor["e0"]) / abs(jax_anchor["e0"])
    print(f"precision anchor N={ANCHOR_N}: the port's E0 {anchor_e0:.12f} against the recorded {jax_anchor['e0']:.12f}: "
          f"rel {e0_rel:.2e} (tol {ANCHOR_E0_RTOL:.0e}); ED {anchor_ed_s:.1f} s on the host")
    _require(e0_rel <= ANCHOR_E0_RTOL, f"precision anchor: E0 off the record by {e0_rel:.2e}")
    reset_counts()
    t_train = time.perf_counter()
    a_machine, a_ham, a_params, _, a_hists, a_warm_s, a_run_s = precision_anchor.train(ANCHOR_N)
    anchor_s = time.perf_counter() - t_train
    launches, plain_calls = read_counts()
    anchor_steps = sum(len(hh) for hh in a_hists)
    anchor_e = float(np.mean([hh["energy"] for hh in a_hists[-1][-precision_anchor.TAIL:]]))
    stage_means = [float(np.mean([hh["energy"] for hh in hist[-100:]])) for hist in a_hists]
    step_ms = 1e3 * a_run_s / anchor_steps
    anchor_rel = abs(anchor_e - anchor_e0) / abs(anchor_e0)
    bar_met = anchor_rel <= precision_anchor.BAR
    print(f"precision anchor N={ANCHOR_N}: card tail energy {anchor_e:.10f} over the last {precision_anchor.TAIL} "
          f"of {anchor_steps} steps; rel err {anchor_rel:.3e} against the port's E0: the paper's bar "
          f"{precision_anchor.BAR:.0e} {'met' if bar_met else 'NOT MET (ROADMAP C10)'}; JAX record "
          f"{jax_anchor['rel_err']:.3e}; step {step_ms:.3f} ms; warm-up {a_warm_s:.2f} s; "
          f"phase {time.perf_counter() - t_ed:.1f} s; launches {launches}; plain-version calls: {plain_calls}")
    _require(launches == expect(sweep=1 + anchor_steps, energy=anchor_steps) and plain_calls == 0
             and anchor_steps == sum(st for st, _ in precision_anchor.STAGES),
             f"precision anchor: {anchor_steps} steps, launches {launches}, plain-version calls {plain_calls}")
    path_launches[f"precision anchor N={ANCHOR_N}"] = launches
    # the card's estimate is the trained state's own energy: <H> of the trained
    # ansatz by enumeration of its 2^20 configurations in float64, variational
    anchor_enum = precision_anchor.variational_energy(a_machine, a_ham, a_params)
    enum_rel = abs(anchor_e - anchor_enum) / abs(anchor_enum)
    print(f"precision anchor N={ANCHOR_N}: the trained state's <H> by enumeration {anchor_enum:.10f}, "
          f"{(anchor_enum - anchor_e0) / abs(anchor_e0):.3e} above E0; the card's tail against it {enum_rel:.2e} "
          f"(tol {ANCHOR_ENUM_RTOL:.0e})")
    _require(math.isfinite(anchor_e) and enum_rel <= ANCHOR_ENUM_RTOL,
             f"precision anchor: the card's tail {anchor_e} off the trained state's <H> {anchor_enum} by {enum_rel:.2e}")
    _require(anchor_enum >= anchor_e0 - 1e-12 * abs(anchor_e0),
             f"precision anchor: enumerated <H> {anchor_enum} below the ground energy {anchor_e0}")
    anchor_result = {"n": ANCHOR_N, "e0": anchor_e0, "e0_recorded": jax_anchor["e0"], "e0_rel": e0_rel,
                     "e_vmc": anchor_e, "rel_err": anchor_rel, "bar": precision_anchor.BAR, "bar_met": bar_met,
                     "enumerated": anchor_enum, "tail_vs_enumerated": enum_rel, "jax_rel_err": jax_anchor["rel_err"],
                     "stage_means": stage_means, "step_ms": step_ms, "ed_s": anchor_ed_s,
                     "train_s": anchor_s}
    print(f"precision anchor: {json.dumps(anchor_result)}")

    _enter("16 kernel device times", t0)
    # the instance each timed call runs: R = ceil(H/32) (exchange: G x U), then c and t
    hub_g = kernel_lanes(HUB_H)
    hub_g64 = kernel_lanes(HUB_H, torch.float64)
    r_of = {lib: f"{hub_g}x{-(-HUB_H // hub_g)}" for lib in ("exchange", "exchange_tempered")}
    r_of |= {lib: f"{hub_g64}x{-(-HUB_H // hub_g64)}" for lib in ("exchange_f64", "exchange_f64_tempered")}
    r_of["sweep_energy"] = f"32x{(h + 31) // 32}"  # lanes x words: one warp a walker above H = 128

    def instance(name, tempered=False, multi=False):
        base = name.removesuffix("_c")
        # the energy kernel's float64 instance is in energy's library
        lib = {"energy_f64": "energy", "chain_rate_energy": "chain_rate"}.get(base, base)
        f64 = base in ("energy_f64", "sweep_f64", "exchange_f64", "exchange_f64_tempered")
        tempered = tempered or base in ("exchange_tempered", "exchange_f64_tempered")
        # the probe: its body; the energy's float64 instance: one for every R
        r = ("" if base == "energy_f64"
             else {"chain_rate": 0, "chain_rate_energy": 1}.get(base, r_of.get(lib, (h + 31) // 32)))
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

    # the sweep's float64 instances, where the JAX package runs XLA
    # (sampler/metropolis.py::_sweep_scan): the operations their form needs
    # at the float64 rate, their bytes in float64 (complex128 y, sa, w, a, c
    # and the table G; float64 spins); beside them the RBM form's L1 floor
    # and the table's time
    f64_sweep_bytes = (2 * K * h * c128 + 2 * K * N * f64b + 2 * K * c128 + 3 * N * h * c128 + 2 * N * c128
                       + 2 * K * i32b + 16)
    sweep_f64_ops = {"": K * N * h * SWEEP_OPS, "_c": K * N * h * SWEEP_OPS_C}
    sweep_f64_bounds = {"": _bound_ms(sweep_f64_ops[""], f64_sweep_bytes, PEAK_F64_FLOPS),
                        "_c": _bound_ms(sweep_f64_ops["_c"], f64_sweep_bytes + h * c128, PEAK_F64_FLOPS)}
    sweep_f64_t_bounds = {"": _bound_ms(sweep_f64_ops[""] + swap_ops, f64_sweep_bytes, PEAK_F64_FLOPS),
                          "_c": _bound_ms(sweep_f64_ops["_c"] + swap_ops, f64_sweep_bytes + h * c128,
                                          PEAK_F64_FLOPS)}
    sweep_f64_form_floor = {"operations": 1e3 * K * N * h * F64_SWEEP_FORM_OPS / PEAK_F64_FLOPS,
                            "l1": 1e3 * K * N * h * F64_FORM_ROW_BYTES / PEAK_SMEM_BYTES_S}
    for c_ in ("", "_c"):
        d_ms = device_ms[f"sweep_f64{c_}"]
        print(f"sweep_f64{c_}: kernel {'not measured' if d_ms is None else f'{d_ms:.4f} ms'}, bound "
              f"{sweep_f64_bounds[c_][0]:.4f} ms ({sweep_f64_bounds[c_][1]}: the "
              f"{SWEEP_OPS_C if c_ else SWEEP_OPS} double operations an element the function needs)"
              + (f"; the form's floors: {sweep_f64_form_floor['operations']:.4f} ms by its {F64_SWEEP_FORM_OPS} "
                 f"operations an element (a power of two per pair of factors), {sweep_f64_form_floor['l1']:.4f} ms "
                 f"by its {F64_FORM_ROW_BYTES} bytes of G an element through L1" if not c_ else ""))

    # the exchange's float64 instances, where the JAX package runs XLA
    # (sampler/kawasaki.py::_exchange_scan): the operations their form needs
    # at the float64 rate, their bytes in float64 (complex128 y, sa, w, a, c
    # and the bond table E with a'; float64 spins), the table row's L1 floor
    # beside them; the sweep's and the exchange's wrappers with a fresh
    # weight tensor a call (the table and its range check built anew, as on
    # the training paths' first call of a step) beside those on the same
    # weights (phase 3, the memo's)
    def exchange_f64_bytes(hh, has_c, tempered):
        return (2 * HUB_K * hh * c128 + 2 * HUB_K * hn * f64b + 2 * HUB_K * c128 + hn * hh * c128 + hn * c128
                + 2 * n_bonds * hh * c128 + hn * c128 + 2 * n_bonds * i32b + (hn + 1 + 2 * n_bonds) * i32b
                + HUB_K * i32b + 16 + (hh * c128 if has_c else 0) + (HUB_K * i32b if tempered else 0))

    x64_ops = {"": HUB_K * n_unit * (HUB_H * EXCHANGE_OPS_HIDDEN + n_bonds * EXCHANGE_OPS_BOND),
               "_c": HUB_K * n_unit * (FFNN_HUB_H * EXCHANGE_OPS_HIDDEN_C + n_bonds * EXCHANGE_OPS_BOND)}
    swap_x_ops = 2 * HUB_K * SWAP_OPS
    exchange_f64_bounds = {
        t_ + c_: _bound_ms(x64_ops[c_] + (swap_x_ops if t_ else 0),
                           exchange_f64_bytes(FFNN_HUB_H if c_ else HUB_H, bool(c_), bool(t_)), PEAK_F64_FLOPS)
        for t_ in ("", "_tempered") for c_ in ("", "_c")}
    exchange_f64_form_floor = {
        "operations": 1e3 * HUB_K * n_unit * (HUB_H * F64_EXCHANGE_FORM_OPS + n_bonds * EXCHANGE_OPS_BOND)
        / PEAK_F64_FLOPS,
        "l1": 1e3 * HUB_K * n_unit * HUB_H * F64_FORM_ROW_BYTES / PEAK_SMEM_BYTES_S}

    def fresh_weights(work_):
        """A call's weights: a new w tensor each time, the other parameters shared."""
        works = itertools.cycle([work_._replace(w=work_.w.clone()) for _ in range(23)])
        return lambda: next(works)

    fresh_s, fresh_x, fresh_xc = (fresh_weights(f64_cases[""][0]), fresh_weights(h64_cases[""][0]),
                                  fresh_weights(h64_cases[" with c"][0]))
    fresh_ms = {
        "sweep_f64": _time_ms(torch, lambda: sweep_cuda(fresh_s(), f64_cases[""][1], sched, philox_draws), 20),
        "exchange_f64": _time_ms(torch, lambda: exchange_cuda(fresh_x(), h64_cases[""][1], bonds, exchange_draws), 20),
        "exchange_f64_c": _time_ms(torch, lambda: exchange_cuda(fresh_xc(), h64_cases[" with c"][1], bonds,
                                                                 exchange_draws), 20),
        "exchange_f64_tempered": _time_ms(torch, lambda: exchange_cuda(fresh_x(), h64_cases[""][1], bonds,
                                                                        exchange_draws, n_beta=TEMPERED_NBETA,
                                                                        n_unit=n_unit), 20),
    }
    for name, f_ms in fresh_ms.items():
        print(f"{name}: wrapper {f_ms:.4f} ms per call with a fresh weight tensor, {timing.get(name, (None,))[0]} ms "
              "on the same weights (CUDA events)")
    # their tables with the range check, as a fresh weight tensor builds them (the same weights reuse them)
    table_ms = {"sweep_f64": _time_ms(torch, lambda: engine.sweep_table_f64(fresh_s()), 20),
                "exchange_f64": _time_ms(torch, lambda: engine.exchange_table_f64(fresh_x(), bonds), 20)}
    for name, t_ms in table_ms.items():
        print(f"{name}: its table and range check (engine.{name.removesuffix('_f64')}_table_f64) {t_ms:.4f} ms "
              "per call with a fresh weight tensor, in the wrapper's time then (CUDA events)")
    for name in ("exchange_f64", "exchange_f64_c", "exchange_f64_tempered", "exchange_f64_tempered_c"):
        d_ms, bkey = device_ms[name], name.removeprefix("exchange_f64")
        print(f"{name}: kernel {'not measured' if d_ms is None else f'{d_ms:.4f} ms'}, bound "
              f"{exchange_f64_bounds[bkey][0]:.4f} ms ({exchange_f64_bounds[bkey][1]}: the "
              f"{EXCHANGE_OPS_HIDDEN_C if bkey.endswith('_c') else EXCHANGE_OPS_HIDDEN} double operations an element the "
              "function needs)"
              + ("" if bkey.endswith("_c") else
                 f"; the form's floors: {exchange_f64_form_floor['operations']:.4f} ms by its {F64_EXCHANGE_FORM_OPS} "
                 f"operations an element (a power of two per factor), {exchange_f64_form_floor['l1']:.4f} ms by its "
                 f"{F64_FORM_ROW_BYTES} bytes of E an element through L1"))
    for line in sass_lines:
        if "exchange float64" in line:
            print(f"SASS per element: {line}")

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

    _enter("22b measure profile", t0)
    # a few profiled estimator iterations of (a) and (b) on the same
    # checkpoints and shapes: device busy share
    from neural_network_quantum_state_tpu_torch.drivers.common import build_machine
    from neural_network_quantum_state_tpu_torch.measurements import AmplitudeSampler
    from neural_network_quantum_state_tpu_torch.measurements.estimators import measure_energy, order_parameter
    from neural_network_quantum_state_tpu_torch.utils.checkpoint import load_reference_text

    b_machine = build_machine("rbmtrsymm", N, ALPHA, torch.float32)
    b_smp = AmplitudeSampler(b_machine, load_reference_text(b_machine, binder_prefix), K, key=21, n_beta=8,
                             use_fused=True)
    b_smp.warm_up(MEAS_SMALL_WARM)
    stag = np.where(np.arange(N) % 2 == 0, 1.0, -1.0)
    meas_results["binder"]["profile"] = _profile(
        torch, lambda: order_parameter(b_smp, stag, MEAS_PROFILE_ITERS, 3, 0), MEAS_PROFILE_ITERS,
        "Binder iteration")
    h_machine = build_machine("rbm", 2 * HUB_L, HUB_H, torch.float32)
    h_smp = fermion_meas.FermionAmplitudeSampler(h_machine, load_reference_text(h_machine, hub_prefix), HUB_K,
                                                 HUB_PARTICLES, HUB_PARTICLES, key=3, use_fused=True)
    h_smp.warm_up(HUB_WARM_SWEEPS)
    meas_results["Hubbard energy"]["profile"] = _profile(  # the trap chain of -trap=HUB_TRAP: `hubbard`
        torch, lambda: measure_energy((h_smp, hubbard), MEAS_PROFILE_ITERS, 3), MEAS_PROFILE_ITERS,
        "Hubbard energy iteration")

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
        "sweep_energy": {"tolerance": SWEEP_LNPSI_ATOL, "offdiag_tolerance": OFFDIAG_RTOL, **mega[1], "stress": mega_stress,
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

    def mesh_launches(name):
        """Kernel ``name``'s launches on the walker-mesh paths (phase 15d)."""
        return sum(v.get(name, 0) for k_, v in path_launches.items() if "mesh" in k_)

    kernels = [
        {
            "name": name, "route": "cuda",
            "source": f"neural_network_quantum_state_tpu_torch/csrc/{name}.cu",
            # launches: both instances, over every path (the mesh's among them); has_c: the instance with c alone
            "replaces": replaces[name], "launches": sum(p[name] for p in path_launches.values()),
            **({"row0": row0_entry(name)} if name in ("sweep", "exchange") else {}),
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
                "kernel_ms": device_ms[name], "wrapper_ms": timing[name][0], "table_ms": f64_table_ms[name],
                "plain_ms": timing[name][1], "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
                "registers": instance(name)[1]}

    # the energy kernel's float64 instance (energy_dtype=float64), where the
    # JAX package runs XLA (hamiltonians/ising.py::_offdiag_sum in float64)
    kernels.append({
        "name": "energy_f64", "route": "cuda", "source": "neural_network_quantum_state_tpu_torch/csrc/energy.cu",
        "replaces": replaces["energy"], "instance_of": "energy",
        **f64_entry("energy_f64", f64_err[""], energy_f64_bound), "form_floor_ms": energy_f64_form_floor,
        "widths_rel_err": {k.strip(): v[0] for k, v in f64_err.items() if "H=" in k},
        "stress_rel_err": {k.strip(): v[0] for k, v in f64_err.items() if "N=" in k},
        "near_cut_share": {k.strip(): v[2] for k, v in f64_err.items() if "with c" in k},
        "has_c": f64_entry("energy_f64_c", f64_err[" with c"], energy_f64_c_bound),
    })

    # the exchange kernel's tempered instance (tempered exchange), where the
    # JAX package runs XLA (sampler/kawasaki.py::tempered_exchange_sweeps): the
    # untempered instance's operations and bytes, the per-row swap counts
    # written, and SWAP_OPS per walker row and swap phase; headline n_beta = 4
    # at one sweep on its Philox stream (swap_x_ops: phase 16's)

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
        "name": "exchange_tempered", "route": "cuda",
        "source": "neural_network_quantum_state_tpu_torch/csrc/exchange_tempered.cu",
        "replaces": replaces["exchange"], "instance_of": "exchange",
        # launches: the tempered instance's, over every path (counted in exchange's too)
        "launches": sum(p.get("exchange_tempered", 0) for p in path_launches.values()),
        **tempered_entry("", exchange_ops, HUB_H),
        # launches: the tempered instance with c alone, over every path
        "has_c": {"launches": sum(p.get("exchange_tempered_c", 0) for p in path_launches.values()),
                  **tempered_entry(" with c", exchange_c_ops, FFNN_HUB_H)},
    })

    def f64_state_entry(name, err, bound, extra=None):
        """A float64 sweep or exchange instance's numbers: its errors (the
        headline mode), device, wrapper and plain times, bound, registers."""
        return {"max_abs_err": err[1], "mismatch_share": err[0], "tolerance": F64_LNPSI_ATOL, "y_rtol": F64_Y_RTOL,
                "ms": device_ms[name] if device_ms[name] is not None else timing[name][0],
                "kernel_ms": device_ms[name], "wrapper_ms": timing[name][0], "plain_ms": timing[name][1],
                "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None, "registers": instance(name)[1],
                **(extra or {})}

    def sweep64_entry(clab, c):
        return f64_state_entry(f"sweep_f64{c}", sweep64[(clab, 1, "philox")], sweep_f64_bounds[c], {
            f"nbeta{CHECK_NBETA}": {"max_abs_err": sweep64[(clab, CHECK_NBETA, "philox")][1],
                                    "mismatch_share": sweep64[(clab, CHECK_NBETA, "philox")][0],
                                    "kernel_ms": tempered_device_ms[f"sweep_f64{c}"],
                                    "wrapper_ms": tempered_ms[f"sweep_f64{c}"],
                                    "bound_ms": sweep_f64_t_bounds[c][0],
                                    "registers": instance(f"sweep_f64{c}", tempered=True)[1]},
            "uniforms": {"max_abs_err": sweep64[(clab, 1, "uniforms")][1],
                         "mismatch_share": sweep64[(clab, 1, "uniforms")][0],
                         f"nbeta{CHECK_NBETA}_max_abs_err": sweep64[(clab, CHECK_NBETA, "uniforms")][1]},
            "multi_sweep": {"sweeps": MULTI_SWEEPS, "max_abs_err": sweep64[(clab, 1, "multi")][1],
                            "mismatch_share": sweep64[(clab, 1, "multi")][0]},
            "widths_max_abs_err": {k[0].strip() + f" n_beta={k[1]}": v[1] for k, v in sweep64.items()
                                   if "H=" in k[0] and k[0].endswith(" with c") == bool(clab)},
            "stress_max_abs_err": {k[0].strip(): v[1] for k, v in sweep64.items()
                                   if "N=" in k[0] and k[0].endswith(" with c") == bool(clab)},
            **({"form_floor_ms": sweep_f64_form_floor} if not clab else {}),
        })

    kernels.append({
        "name": "sweep_f64", "route": "cuda", "source": "neural_network_quantum_state_tpu_torch/csrc/sweep_f64.cu",
        "replaces": replaces["sweep"], "instance_of": "sweep",
        "launches": sum(p.get("sweep_f64", 0) for p in path_launches.values()),
        "row0": row0_entry("sweep_f64"), "wrapper_fresh_weights_ms": fresh_ms["sweep_f64"],
        "table_fresh_weights_ms": table_ms["sweep_f64"],
        **sweep64_entry("", ""), "has_c": sweep64_entry(" with c", "_c"),
    })

    def exchange64_entry(clab, c, tempered):
        nb = TEMPERED_NBETA if tempered else 1
        name = f"exchange_f64{'_tempered' if tempered else ''}{c}"
        bound = exchange_f64_bounds[("_tempered" if tempered else "") + c]
        return f64_state_entry(name, exchange64[(clab, nb, "philox")], bound, {
            "n_beta": nb,
            "uniforms": {"max_abs_err": exchange64[(clab, nb, "uniforms")][1],
                         "mismatch_share": exchange64[(clab, nb, "uniforms")][0]},
            "multi_sweep": {"sweeps": EXCHANGE_MULTI_SWEEPS, "max_abs_err": exchange64[(clab, nb, "multi")][1],
                            "mismatch_share": exchange64[(clab, nb, "multi")][0]},
            **({f"nbeta{CHECK_NBETA}_max_abs_err": exchange64[(clab, CHECK_NBETA, "philox")][1],
                f"nbeta{CHECK_NBETA}_mismatch_share": exchange64[(clab, CHECK_NBETA, "philox")][0]} if tempered else {}),
            "widths_max_abs_err": {k[0].strip() + f" n_beta={k[1]}": v[1] for k, v in exchange64.items()
                                   if "H=" in k[0] and k[1] == nb and k[0].endswith(" with c") == bool(clab)},
            **({"stress_max_abs_err": {f"{k[0].strip()} {k[2]}": v[1] for k, v in exchange64.items()
                                       if "N=" in k[0] and k[0].endswith(" with c") == bool(clab)}} if nb == 1 else {}),
            **({"wrapper_fresh_weights_ms": fresh_ms[name]} if name in fresh_ms else {}),
            **({"form_floor_ms": exchange_f64_form_floor} if not clab else {}),
        })

    kernels.append({
        "name": "exchange_f64", "route": "cuda", "source": "neural_network_quantum_state_tpu_torch/csrc/exchange_f64.cu",
        "replaces": replaces["exchange"], "instance_of": "exchange",
        # launches: every float64 instance's, over every path (the tempered ones also below)
        "launches": sum(p.get("exchange_f64", 0) for p in path_launches.values()),
        "row0": row0_entry("exchange_f64"), "table_fresh_weights_ms": table_ms["exchange_f64"],
        "sass": [line for line in sass_lines if "exchange float64" in line],
        **exchange64_entry("", "", False), "has_c": exchange64_entry(" with c", "_c", False),
        "tempered": {"source": "neural_network_quantum_state_tpu_torch/csrc/exchange_f64_tempered.cu",
                     "launches": sum(p.get("exchange_f64_tempered", 0) for p in path_launches.values()),
                     **exchange64_entry("", "", True), "has_c": exchange64_entry(" with c", "_c", True)},
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
    for entry in kernels:  # of every kernel's launches, those on the walker-mesh paths (phase 15d)
        entry["mesh_launches"] = mesh_launches(entry["name"])
    print(f"solver cross-check: {json.dumps(solver_check)}; auto's MINRES-QLP fallbacks: {json.dumps(auto_fallbacks)}")
    print(f"measure driver: {json.dumps(meas_results)}")
    print(f"walker mesh: {json.dumps(mesh_results)}")
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
