#!/usr/bin/env python3
"""The sweep kernel of this tree against other sources of it, on one NVIDIA GPU.

    python3 scripts/sweep_ab.py LABEL=CSRC_DIR [LABEL=CSRC_DIR ...]

Builds ``csrc/sweep.cu`` of the package ("change") and of each given source
directory (for example an earlier commit's
``neural_network_quantum_state_tpu_torch/csrc``, unpacked with
``git archive``), one ``nvcc`` process per build, all started together,
into the port's gitignored build directory. The builds share the package's
C interface. Each build in turn is loaded as the package's sweep library
(``ops.build.load``) and driven through ``ops.sweep.sweep_cuda`` at the
LITFI flagship's width (N=64, H=256, K=8192) on the kernel's Philox stream:
the RBM family (``RBMTrSymm(64, alpha=4)``) and the instance with output
weights c (``FFNN(64, 256)``), one sweep and five sweeps in one launch at
n_beta = 1, and one sweep of the tempered instance at n_beta = 8. Each
build is first held against the plain sweep on the same stream (the share
of walkers with other decisions, or near the log-cosh's branch cut with c,
at most 1e-3; y within 1e-5 on the others). Then each is timed by
``torch.profiler`` (the kernel's device time, mean of 20 launches) in
rounds that alternate the order: the builds, the builds reversed, the
builds, the builds reversed. Prints the registers and spill bytes of the
R = 8 instances (``ptxas -v``), one line per timing, a JSON object of the
times, and the card's name and power limit. Exits 1 without a CUDA device
or on a disagreement. Imports no JAX.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

N, ALPHA, K, SCALE, REPS = 64, 4, 8192, 10.0, 20
CASES = ((1, 1), (5, 1), (1, 8))  # (sweeps in one launch, n_beta)
MISMATCH_MAX, Y_ATOL = 1e-3, 1e-5
FLAGS = "ctm"  # the sweep kernel's template flags after R: c, tempered, multi-sweep restart


def build_all(build, sources: dict[str, Path]) -> dict[str, tuple[Path, str]]:
    """{label: (library, registers of the R = 8 instances by their flags)}."""
    out_dir = build.BUILD_DIR / "sweep_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, src in sources.items():
        lib = out_dir / f"sweep_{label}.so"
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src / "sweep.cu")]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    built = {}
    for label, (proc, lib) in procs.items():
        log, _ = proc.communicate(timeout=build.NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            raise SystemExit(f"sweep_ab: nvcc failed for {label}:\n{log}")
        regs, key, spill = {}, None, 0
        for line in log.splitlines():
            m = re.search(r"sweep_kernelILi8E((?:Lb\dE)+)E", line)
            if "Compiling entry function" in line and m:
                flags = re.findall(r"Lb(\d)E", m.group(1))
                key, spill = "8" + "".join(f for f, v in zip(FLAGS, flags) if v == "1"), 0
            elif key is not None and "spill stores" in line:
                spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
            elif key is not None and "registers" in line:
                regs[key] = re.search(r"Used (\d+) registers", line).group(1) + (f"+{spill}B" if spill else "")
                key = None
        built[label] = (lib, ", ".join(f"{k} {v}" for k, v in sorted(regs.items())))
    return built


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("sweep_ab: no CUDA device", file=sys.stderr)
        return 1
    from neural_network_quantum_state_tpu_torch.hamiltonians import LITFIChain
    from neural_network_quantum_state_tpu_torch.models import FFNN, RBMTrSymm
    from neural_network_quantum_state_tpu_torch.ops import build, engine
    from neural_network_quantum_state_tpu_torch.ops import sweep as sweep_ops
    from neural_network_quantum_state_tpu_torch.ops.logcosh import near_branch_cut
    from neural_network_quantum_state_tpu_torch.ops.rng import PhiloxDraws, make_generator, philox_key, random_spins

    sources = {"change": build.CSRC_DIR}
    for arg in sys.argv[1:]:
        label, _, path = arg.partition("=")
        sources[label] = Path(path)
    built = build_all(build, sources)
    dev = torch.device("cuda")
    g = make_generator(7, dev)
    rbm, ffnn = RBMTrSymm(n_inputs=N, alpha=ALPHA, dtype=torch.float32), FFNN(n_inputs=N, n_hiddens=N * ALPHA,
                                                                               dtype=torch.float32)
    # weights scaled as chip_smoke.py's comparisons scale them
    works = {"rbm": rbm.make_work({k: SCALE * v for k, v in rbm.init_params(g).items()}),
             "c": ffnn.make_work({k: torch.complex(v.real, SCALE * v.imag) for k, v in ffnn.init_params(g).items()})}
    states = {kind: engine.full_forward(w, random_spins(g, K, N)) for kind, w in works.items()}
    sched = torch.as_tensor(LITFIChain(n_sites=N).schedule())
    draws = {n: PhiloxDraws(philox_key(g), n * N) for n in {n for n, _ in CASES}}

    def device_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and "sweep_kernel" in e.key]
        return sum(e.self_device_time_total for e in evs) / 1e3 / sum(e.count for e in evs)

    for label, (lib, regs) in built.items():
        build.load("sweep", lib)
        for kind, work in works.items():
            cache, ln = states[kind]
            for n, nb in CASES:
                ck, _, _ = sweep_ops.sweep_cuda(work, cache, sched, draws[n], nb)
                cp, _, _ = sweep_ops.sweep_plain(work, cache, ln, sched, draws[n], nb)
                differ = (ck.spins != cp.spins).any(dim=1)
                if kind == "c":
                    differ |= near_branch_cut(ck.y) | near_branch_cut(cp.y)
                share, dy = float(differ.double().mean()), float((ck.y[~differ] - cp.y[~differ]).abs().max())
                print(f"{label} ({kind}, {n} sweeps, n_beta={nb}): other decisions than the plain sweep {share:.2e} "
                      f"(max {MISMATCH_MAX:.0e}), max|dy| {dy:.2e} (tol {Y_ATOL:.0e})")
                if not (share <= MISMATCH_MAX and dy <= Y_ATOL):
                    raise SystemExit(f"sweep_ab: {label} ({kind}, {n} sweeps, n_beta={nb}) disagrees with the plain sweep")
        print(f"{label}: registers (+spill bytes) of the R = 8 instances: {regs}", flush=True)

    times: dict[str, list[float]] = {}
    order = list(built)
    for labels in (order, order[::-1], order, order[::-1]):
        for label in labels:
            build.load("sweep", built[label][0])
            for kind, work in works.items():
                cache, _ = states[kind]
                for n, nb in CASES:
                    ms = device_ms(lambda: sweep_ops.sweep_cuda(work, cache, sched, draws[n], nb))
                    times.setdefault(f"{label} {kind} {n} nb{nb}", []).append(ms)
                    print(f"{label} ({kind}, {n} sweeps in one launch, n_beta={nb}): kernel {ms:.4f} ms", flush=True)
    print(json.dumps({"sweep_ab_ms": times}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
