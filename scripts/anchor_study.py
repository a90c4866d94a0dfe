#!/usr/bin/env python3
"""The precision anchor's training on one NVIDIA GPU, seed by seed, with
what separates sampling from optimization.

    python3 scripts/anchor_study.py [--n 20] [--seeds 11 12] [--arms mixed f64] [--stages 3000:2e-2 ...] [--out FILE]

For each (arm, seed) it trains RBMTrSymm(n, alpha 4) on the paper's LITFI
chain as ``examples/precision_anchor.py`` does (``mixed``: float32 sampling
and local energies with the float64 solve, the anchor's mode; ``f64``: a
float64 machine, every part in float64) and reports: each stage's mean
energy over its last 100 steps; the tail mean over the last 1000 steps
(the anchor's estimate); the trained state's exact <H> by enumeration of
its 2^n configurations (float64; n <= 24); their relative errors against
the port's ED (``precision_anchor.run_ed``); and, on the trained state,
the sweep kernel's decisions and the energy kernel's sums against their
plain versions on the same inputs (the walkers, one sweep on caller
uniforms); and, first, the ground energy (ED) and then what the diagonal
energy of each trained state moves by where J is rounded to bfloat16 (``bf16_j_shift``, by enumeration; a float32
matmul at a TPU's default precision rounds its operands so), with the
tail's relative error so shifted. A tail far above the enumerated energy means the sampling is
biased; both far above E0 means the optimization stopped short. One JSON
line per run, and all of them as the last line (also to --out). Exits 1
without a CUDA device. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _bf16_shift(machine, ham, params, chunk=1 << 16):
    """<0.5 s.(bf16(J) - J).s / n> over |psi|^2 of the state: what the
    diagonal energy moves by when its dense (K, n) x (n, n) product rounds J
    to bfloat16, as a float32 matmul at a TPU's default precision does."""
    import torch

    from neural_network_quantum_state_tpu_torch.ops import engine

    n = machine.n_inputs
    dev = next(iter(params.values())).device
    jm = torch.as_tensor(ham.j_matrix, dtype=torch.float64, device=dev)
    dj = jm.float().bfloat16().double() - jm
    work = machine.make_work({k: v.to(torch.complex128) for k, v in params.items()})
    parts = []
    for lo in range(0, 1 << n, chunk):
        idx = torch.arange(lo, min(lo + chunk, 1 << n), device=dev)
        spins = 1.0 - 2.0 * ((idx[:, None] >> torch.arange(n, device=dev)[None, :]) & 1).to(torch.float64)
        parts.append((engine.log_psi(work, spins).real, 0.5 * ((spins @ dj) * spins).sum(1) / n))
    top = max(float(ln.max()) for ln, _ in parts)
    num = sum(float((torch.exp(2.0 * (ln - top)) * d).sum()) for ln, d in parts)
    den = sum(float(torch.exp(2.0 * (ln - top)).sum()) for ln, _ in parts)
    return num / den


def _stages(text):
    steps, lr = text.split(":")
    return int(steps), float(lr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=20)
    ap.add_argument("--seeds", type=int, nargs="*", default=[11])
    ap.add_argument("--arms", nargs="+", default=["mixed"], choices=["mixed", "f64"])
    ap.add_argument("--stages", type=_stages, nargs="+", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("anchor_study: no CUDA device", file=sys.stderr)
        return 1
    from neural_network_quantum_state_tpu_torch.examples import precision_anchor as pa
    from neural_network_quantum_state_tpu_torch.ops import engine
    from neural_network_quantum_state_tpu_torch.ops.energy import offdiag_sum_cuda, offdiag_sum_plain
    from neural_network_quantum_state_tpu_torch.ops.rng import make_generator, uniform_block
    from neural_network_quantum_state_tpu_torch.ops.sweep import sweep_cuda, sweep_plain

    stages = tuple(args.stages) if args.stages else pa.STAGES
    with tempfile.TemporaryDirectory() as tmp:
        e0 = pa.run_ed(args.n, tmp)
    # the ground energy where J is rounded to bfloat16 (n <= 24)
    e0_bf16 = pa.lanczos_e0(args.n, torch.tensor(pa._j_matrix(args.n)).float().bfloat16().double().numpy()) \
        if args.n <= 24 else None
    if e0_bf16 is not None:
        print(json.dumps({"n": args.n, "e0": e0, "e0_bf16_j": e0_bf16, "shift_rel": (e0_bf16 - e0) / abs(e0)}),
              flush=True)
    results = []
    for arm in args.arms:
        for seed in args.seeds:
            t0 = time.time()
            machine, ham, params, state, hists, t_warm, run_s = pa.train(
                args.n, seed, "cuda", stages=stages, dtype=torch.float64 if arm == "f64" else None)
            steps = sum(len(h) for h in hists)
            tail = float(np.mean([h["energy"] for h in hists[-1][-pa.TAIL:]]))
            enum = pa.variational_energy(machine, ham, params) if args.n <= 24 else None
            shift = _bf16_shift(machine, ham, params) if args.n <= 24 else None
            work = machine.make_work(params)
            cache, lnpsi = engine.full_forward(work, state.cache.spins)
            g = make_generator(seed + 1000, "cuda")
            sched = torch.as_tensor(ham.schedule())
            u = uniform_block(g, (len(sched), cache.spins.shape[0]), cache.spins.dtype)
            ck, _, _ = sweep_cuda(work, cache, sched, u)
            cp, _, _ = sweep_plain(work, cache, lnpsi, sched, u)
            sums_k, sums_p = offdiag_sum_cuda(work, cache), offdiag_sum_plain(work, cache, lnpsi)
            rec = {"arm": arm, "seed": seed, "n": args.n, "e0": e0, "stage_means": [
                float(np.mean([h["energy"] for h in hist[-100:]])) for hist in hists], "tail": tail,
                "tail_rel_err": abs(tail - e0) / abs(e0), "enumerated": enum,
                "enumerated_rel_err": None if enum is None else abs(enum - e0) / abs(e0),
                "bf16_j_shift": shift, "bf16_j_tail_rel_err": None if shift is None else (tail + shift - e0) / abs(e0),
                "sweep_mismatch_share": float((ck.spins != cp.spins).any(1).double().mean()),
                "energy_rel_err": float((sums_k - sums_p).abs().max() / sums_p.abs().max()),
                "max_abs_re_w": float(work.w.real.abs().max()), "step_ms": 1e3 * run_s / steps,
                "warm_up_s": t_warm, "seconds": time.time() - t0, "device": torch.cuda.get_device_name(0)}
            print(json.dumps(rec), flush=True)
            results.append(rec)
    line = json.dumps({"anchor_study": results, "e0_bf16_j": e0_bf16})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
