"""The sweep kernel's float64 instances against an earlier build of them, on one NVIDIA GPU.

    python -m neural_network_quantum_state_tpu_torch.sweep_f64_ab [LABEL=CSRC_DIR ...]

Builds ``csrc/sweep_f64.cu`` as the package builds it ("change") and the
``sweep_f64.cu`` of each given source directory with the same C entry point
(an earlier commit's ``csrc``, unpacked with ``git archive``), one ``nvcc``
each, all started together, into the port's gitignored build directory.
Loads each build in turn as the package's library (``ops.build.load``) and
drives it through ``ops.sweep.sweep_cuda`` on the Philox stream at N=64,
K=8192 (``RBMTrSymm(64, alpha=H/64)`` and ``FFNN(64, H)`` in complex128,
weights scaled as ``chip_smoke.py``'s comparisons scale them): at the LITFI
flagship's H=256 1 and 5 sweeps in one launch at n_beta = 1 and one sweep
at n_beta = 8, and at H = 384 and 512 one sweep at n_beta = 1, 8 and 16. Each
build is first held to the plain float64 sweep on the same draws (the
share of walkers with other decisions, or with c near the branch cut, at
most 1e-3; y within 1e-12 of its largest |value| on the others), then each
case is timed by ``torch.profiler`` (the kernel's device time, mean of 20
launches) in four rounds that alternate the order of the builds. Prints the
registers and spill bytes of the R = 8, 12 and 16 instances (``ptxas -v``),
one line per timing, and one JSON object of the times with the card's name
and power limit. Exits 1 without a CUDA device or on a disagreement.
Imports no JAX.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

SCALE, REPS, ROUNDS = 10.0, 20, 4  # weights scaled as chip_smoke.py's; launches per timing; alternating rounds
MISMATCH_MAX, Y_RTOL = 1e-3, 1e-12
N, K = 64, 8192
# (H, sweeps in one launch, n_beta) of each case, for both families
SHAPES = ((256, 1, 1), (256, 5, 1), (256, 1, 8), (384, 1, 1), (384, 1, 8), (384, 1, 16), (512, 1, 1), (512, 1, 8),
          (512, 1, 16))
REGISTER_R = ("8", "12", "16")  # the instances whose registers are printed


def registers(log: str) -> dict[str, str]:
    """{instance: registers(+spill bytes)} of the REGISTER_R instances (R,
    then c: with c, t: tempered, n: narrow, d), or of a build with one
    instance for every R, from its ``ptxas -v``."""
    regs, key, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"sweep_kernel_f64I(?:Li(\d+)E)?((?:Lb\dE)+)E", line)
        if "Compiling entry function" in line and m:
            flags = re.findall(r"Lb(\d)E", m.group(2))
            key = (m.group(1) or "") + "".join(f for f, v in zip("ctn", flags) if v == "1") + "d"
            spill = 0
        elif key is not None and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif key is not None and "registers" in line:
            if re.match(r"\d*", key).group() in (*REGISTER_R, ""):
                regs[key] = re.search(r"Used (\d+) registers", line).group(1) + (f"+{spill}B" if spill else "")
            key = None
    return regs


def build_all(build, sources: dict[str, Path]) -> dict[str, tuple[Path, dict]]:
    """{label: (library, registers)}: every source built at once."""
    out_dir = build.BUILD_DIR / "sweep_f64_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, src in sources.items():
        lib = out_dir / f"sweep_f64_{label}.so"
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)]
        procs[label] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for label, (lib, proc) in procs.items():
        log, _ = proc.communicate(timeout=build.NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            raise SystemExit(f"sweep_f64_ab: nvcc failed for {label}:\n{log}")
        built[label] = (lib, registers(log))
    return built


def device_ms(torch, fn) -> float:
    """Mean device time of the float64 sweep kernel over REPS calls of fn."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA and "sweep_kernel_f64" in ev.key]
    count = sum(ev.count for ev in evs)
    if not count:
        raise SystemExit("sweep_f64_ab: the profiler saw no sweep_kernel_f64 launch")
    return sum(ev.self_device_time_total for ev in evs) / 1e3 / count


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("sweep_f64_ab: no CUDA device", file=sys.stderr)
        return 1
    from neural_network_quantum_state_tpu_torch.hamiltonians import LITFIChain
    from neural_network_quantum_state_tpu_torch.models import FFNN, RBMTrSymm
    from neural_network_quantum_state_tpu_torch.ops import build, engine
    from neural_network_quantum_state_tpu_torch.ops.logcosh import near_branch_cut
    from neural_network_quantum_state_tpu_torch.ops.rng import PhiloxDraws, make_generator, philox_key, random_spins
    from neural_network_quantum_state_tpu_torch.ops.sweep import sweep_cuda, sweep_plain

    sources = {"change": build.CSRC_DIR / "sweep_f64.cu"}
    for arg in argv:
        label, _, path = arg.partition("=")
        if not path or not (Path(path) / "sweep_f64.cu").exists():
            raise SystemExit(f"sweep_f64_ab: expected LABEL=CSRC_DIR holding sweep_f64.cu, got {arg!r}")
        sources[label] = Path(path) / "sweep_f64.cu"
    built = build_all(build, sources)
    for label, (lib, regs) in built.items():
        print(f"{label}: {lib.name}, registers (R, then c: with c, t: tempered, n: narrow, d): {regs}")

    dev = torch.device("cuda")
    g = make_generator(1234, dev)
    sched = torch.as_tensor(LITFIChain(n_sites=N).schedule())
    cases = {}
    for h in sorted({shape[0] for shape in SHAPES}):
        rbm = RBMTrSymm(n_inputs=N, alpha=h // N, dtype=torch.float64)
        ffnn = FFNN(n_inputs=N, n_hiddens=h, dtype=torch.float64)
        works = {"rbm": rbm.make_work({k_: SCALE * v for k_, v in rbm.init_params(g).items()}),
                 "c": ffnn.make_work({k_: torch.complex(v.real, SCALE * v.imag)
                                      for k_, v in ffnn.init_params(g).items()})}
        for kind, work in works.items():
            cache, ln = engine.full_forward(work, random_spins(g, K, N).double())
            for _, sweeps, nb in (shape for shape in SHAPES if shape[0] == h):
                cases[f"{kind}, H={h}, {sweeps} sweeps, n_beta={nb}"] = (
                    work, cache, ln, PhiloxDraws(philox_key(g), sweeps * N), nb)

    failed = []
    for label, (lib, _) in built.items():
        build.load("sweep_f64", lib)
        for case, (work, cache, ln, draws, nb) in cases.items():
            ck = sweep_cuda(work, cache, sched, draws, nb)[0]
            cp = sweep_plain(work, cache, ln, sched, draws, nb)[0]
            differ = (ck.spins != cp.spins).any(1)
            if work.c is not None:
                differ |= near_branch_cut(ck.y) | near_branch_cut(cp.y)
            share = float(differ.double().mean())
            dy = float((ck.y[~differ] - cp.y[~differ]).abs().max()) / float(cp.y.abs().max())
            ok = share <= MISMATCH_MAX and dy <= Y_RTOL
            print(f"{label}, {case}: other decisions {share:.2e} (max {MISMATCH_MAX:.0e}), max|dy| / max|y| {dy:.2e} "
                  f"(tol {Y_RTOL:.0e}){'' if ok else '  FAILED'}")
            if not ok:
                failed.append(f"{label}, {case}")
    if failed:
        print(f"sweep_f64_ab: disagreements: {failed}", file=sys.stderr)
        return 1

    times = {label: {case: [] for case in cases} for label in built}
    labels = list(built)
    for rnd in range(ROUNDS):
        for label in labels if rnd % 2 == 0 else labels[::-1]:
            build.load("sweep_f64", built[label][0])
            for case, (work, cache, _, draws, nb) in cases.items():
                ms = device_ms(torch, lambda: sweep_cuda(work, cache, sched, draws, nb))
                times[label][case].append(ms)
                print(f"round {rnd} {label}, {case}: {ms:.4f} ms (device time, profiler)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                      "registers": {label: regs for label, (_, regs) in built.items()}, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
