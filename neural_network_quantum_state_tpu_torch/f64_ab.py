"""The float64 sweep or exchange kernel against earlier builds of it, on one NVIDIA GPU.

    python -m neural_network_quantum_state_tpu_torch.f64_ab sweep|exchange [--no-gate] [LABEL=CSRC_DIR ...]

Builds the kernel's float64 sources as the package builds them ("change":
``csrc/sweep_f64.cu``, or ``csrc/exchange_f64.cu`` and
``csrc/exchange_f64_tempered.cu``) and those of each given source directory
with the same C entry point (an earlier commit's ``csrc``, unpacked with
``git archive``, where one ``exchange_f64.cu`` serves both ladders; or a
variant of this one), one ``nvcc`` each, all started together, into the
port's gitignored build directory. Loads each build in turn as the package's
libraries (``ops.build.load``) and drives it through the package's wrapper
on the Philox stream:

- sweep: ``ops.sweep.sweep_cuda`` at N=64, K=8192 (``RBMTrSymm(64,
  alpha=H/64)`` and ``FFNN(64, H)``): at the LITFI flagship's H=256 1 and 5
  sweeps in one launch at n_beta = 1 and one sweep at n_beta = 8, and at
  H = 384 and 512 one sweep at n_beta = 1, 8 and 16;
- exchange: ``ops.exchange.exchange_cuda`` on the L = 32 Hubbard chain's
  bonds (N = 64 = B, 5 + 5 particles), K=4096 (``RBM(64, H)`` and ``FFNN(64,
  H)``), one sweep of 64 proposals at H = 16, 64, 80 and 384 and n_beta =
  1, 4 and 8;

in complex128, the weights scaled as ``chip_smoke.py``'s comparisons scale
them. Each build is first held to the plain float64 version on the same
draws (the share of walkers with other decisions, or with c near the branch
cut, at most 1e-3; y within 1e-12 of its largest |value| on the others;
``--no-gate`` reports and goes on, for a variant that computes another
function), then each case is timed by ``torch.profiler`` (the kernel's
device time, mean of 20 launches) in four rounds that alternate the order of
the builds. Prints the registers and spill bytes of the instances (``ptxas
-v``), whether each build's states equal the change's to the bit, one line
per timing, and one JSON object of the times with the
card's name and power limit. Exits 1 without a CUDA device or on a
disagreement. Imports no JAX.
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
# (H, sweeps in one launch, n_beta) of each sweep case, for both families
SHAPES = ((256, 1, 1), (256, 5, 1), (256, 1, 8), (384, 1, 1), (384, 1, 8), (384, 1, 16), (512, 1, 1), (512, 1, 8),
          (512, 1, 16))
REGISTER_R = ("8", "12", "16")  # the sweep instances whose registers are printed
# the exchange's cases: the L = 32 trap chain's shapes, K walkers, every H and n_beta, both families
X_L, X_K, X_PARTICLES = 32, 4096, 5
X_WIDTHS, X_NBETAS = (16, 64, 80, 384), (1, 4, 8)
# each kernel's libraries: the package's name of each and the sources that build it in a directory
# (an earlier exchange has one source for both ladders)
LIBRARIES = {"sweep": {"sweep_f64": ("sweep_f64.cu",)},
             "exchange": {"exchange_f64": ("exchange_f64.cu",),
                          "exchange_f64_tempered": ("exchange_f64_tempered.cu", "exchange_f64.cu")}}
PROFILED = {"sweep": "sweep_kernel_f64", "exchange": "exchange_kernel_f64"}


def registers(log: str) -> dict[str, str]:
    """{instance: registers(+spill bytes)} from a build's ``ptxas -v``: of the
    sweep, the REGISTER_R instances (R, then c: with c, t: tempered, n:
    narrow, d); of the exchange, every instance (G x U, then c and t, d); of
    a build with one instance for every R or H, its flags alone."""
    regs, key, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"(sweep|exchange)_kernel_f64I((?:Li\d+E)*)((?:Lb\dE)+)E", line)
        if "Compiling entry function" in line and m:
            ints = "x".join(re.findall(r"Li(\d+)E", m.group(2)))
            flags = re.findall(r"Lb(\d)E", m.group(3))
            key = ints + "".join(f for f, v in zip("ctn", flags) if v == "1") + "d"
            keep = m.group(1) == "exchange" or re.match(r"\d*", key).group() in (*REGISTER_R, "")
            spill = 0
        elif key is not None and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif key is not None and "registers" in line:
            if keep:
                regs[key] = re.search(r"Used (\d+) registers", line).group(1) + (f"+{spill}B" if spill else "")
            key = None
    return regs


def sources_of(kernel: str, csrc: Path) -> dict[str, Path]:
    """{library: source} of `kernel` in the directory `csrc`."""
    out = {}
    for lib, names in LIBRARIES[kernel].items():
        found = [csrc / name for name in names if (csrc / name).exists()]
        if not found:
            raise SystemExit(f"f64_ab: {csrc} holds none of {names}")
        out[lib] = found[0]
    return out


def build_all(build, sources: dict[str, dict[str, Path]]) -> dict[str, tuple[dict[str, Path], dict]]:
    """{label: ({library: path}, registers)}: every source built at once."""
    out_dir = build.BUILD_DIR / "f64_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, libs in sources.items():
        for lib, src in libs.items():
            path = out_dir / f"{lib}_{label}.so"
            cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", str(path), str(src)]
            procs[label, lib] = (path, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {label: ({}, {}) for label in sources}
    for (label, lib), (path, proc) in procs.items():
        log, _ = proc.communicate(timeout=build.NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            raise SystemExit(f"f64_ab: nvcc failed for {label} {lib}:\n{log}")
        built[label][0][lib] = path
        built[label][1].update(registers(log))
    return built


def device_ms(torch, fn, kernel_name: str) -> float:
    """Mean device time of the kernel named `kernel_name` over REPS calls of fn."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA and kernel_name in ev.key]
    count = sum(ev.count for ev in evs)
    if not count:
        raise SystemExit(f"f64_ab: the profiler saw no {kernel_name} launch")
    return sum(ev.self_device_time_total for ev in evs) / 1e3 / count


def sweep_cases(torch, g):
    """{case: (kernel call, plain call)} of the sweep."""
    from neural_network_quantum_state_tpu_torch.hamiltonians import LITFIChain
    from neural_network_quantum_state_tpu_torch.models import FFNN, RBMTrSymm
    from neural_network_quantum_state_tpu_torch.ops import engine
    from neural_network_quantum_state_tpu_torch.ops.rng import PhiloxDraws, philox_key, random_spins
    from neural_network_quantum_state_tpu_torch.ops.sweep import sweep_cuda, sweep_plain

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
                draws = PhiloxDraws(philox_key(g), sweeps * N)
                cases[f"{kind}, H={h}, {sweeps} sweeps, n_beta={nb}"] = (
                    lambda w=work, c=cache, d=draws, b=nb: sweep_cuda(w, c, sched, d, b),
                    lambda w=work, c=cache, l_=ln, d=draws, b=nb: sweep_plain(w, c, l_, sched, d, b))
    return cases


def exchange_cases(torch, g):
    """{case: (kernel call, plain call)} of the exchange."""
    from neural_network_quantum_state_tpu_torch.hamiltonians import HubbardChain
    from neural_network_quantum_state_tpu_torch.models import FFNN, RBM
    from neural_network_quantum_state_tpu_torch.ops import engine
    from neural_network_quantum_state_tpu_torch.ops.exchange import exchange_cuda, tempered_exchange_plain
    from neural_network_quantum_state_tpu_torch.ops.rng import ExchangeDraws, philox_key

    ham = HubbardChain(n_sites=2 * X_L, n_up=X_PARTICLES, n_down=X_PARTICLES)
    n = 2 * X_L
    bonds = torch.as_tensor(ham.bonds, device=g.device)
    cases = {}
    for h in X_WIDTHS:
        rbm = RBM(n_inputs=n, n_hiddens=h, dtype=torch.float64)
        ffnn = FFNN(n_inputs=n, n_hiddens=h, dtype=torch.float64)
        works = {"rbm": rbm.make_work({k_: SCALE * v for k_, v in rbm.init_params(g).items()}),
                 "c": ffnn.make_work({k_: torch.complex(v.real, SCALE * v.imag)
                                      for k_, v in ffnn.init_params(g).items()})}
        for kind, work in works.items():
            cache, ln = engine.full_forward(work, ham.init_spins(g, X_K, torch.float64))
            for nb in X_NBETAS:
                draws = ExchangeDraws(philox_key(g), n)
                cases[f"{kind}, H={h}, n_beta={nb}"] = (
                    lambda w=work, c=cache, d=draws, b=nb: exchange_cuda(w, c, bonds, d, None, b, n),
                    lambda w=work, c=cache, l_=ln, d=draws, b=nb: tempered_exchange_plain(w, c, l_, bonds, d, None, b, n))
    return cases


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("f64_ab: no CUDA device", file=sys.stderr)
        return 1
    from neural_network_quantum_state_tpu_torch.ops import build
    from neural_network_quantum_state_tpu_torch.ops.logcosh import near_branch_cut
    from neural_network_quantum_state_tpu_torch.ops.rng import make_generator

    if not argv or argv[0] not in LIBRARIES:
        raise SystemExit(f"f64_ab: the first argument names the kernel, one of {sorted(LIBRARIES)}")
    kernel, args = argv[0], argv[1:]
    gate = "--no-gate" not in args
    sources = {"change": sources_of(kernel, build.CSRC_DIR)}
    for arg in (a for a in args if a != "--no-gate"):
        label, _, path = arg.partition("=")
        if not path:
            raise SystemExit(f"f64_ab: expected LABEL=CSRC_DIR, got {arg!r}")
        sources[label] = sources_of(kernel, Path(path))
    built = build_all(build, sources)
    for label, (_, regs) in built.items():
        print(f"{label}: registers (R or G x U, then c: with c, t: tempered, n: narrow, d): {regs}")

    g = make_generator(1234, torch.device("cuda"))
    cases = (sweep_cases if kernel == "sweep" else exchange_cases)(torch, g)
    plains = {case: plain()[0] for case, (_, plain) in cases.items()}

    labels_ = list(built)

    def load(label):
        for lib, path in built[label][0].items():
            build.load(lib, path)

    failed, first = [], {}
    for label in built:
        load(label)
        for case, (run, _) in cases.items():
            ck, cp = run()[0], plains[case]
            same = first.setdefault(case, ck)
            bits = torch.equal(ck.spins, same.spins) and torch.equal(ck.y, same.y) and torch.equal(ck.sa, same.sa)
            differ = (ck.spins != cp.spins).any(1) | near_branch_cut(ck.y) | near_branch_cut(cp.y)
            share = float(differ.double().mean())
            dy = float((ck.y[~differ] - cp.y[~differ]).abs().max()) / float(cp.y.abs().max()) if share < 1 else 0.0
            ok = share <= MISMATCH_MAX and dy <= Y_RTOL
            print(f"{label}, {case}: other decisions {share:.2e} (max {MISMATCH_MAX:.0e}), max|dy| / max|y| {dy:.2e} "
                  f"(tol {Y_RTOL:.0e}); bit-equal to {labels_[0]}: {bits}{'' if ok else '  DIFFERS'}")
            if not ok:
                failed.append(f"{label}, {case}")
    if failed and gate:
        print(f"f64_ab: disagreements: {failed}", file=sys.stderr)
        return 1

    times = {label: {case: [] for case in cases} for label in built}
    labels = list(built)
    for rnd in range(ROUNDS):
        for label in labels if rnd % 2 == 0 else labels[::-1]:
            load(label)
            for case, (run, _) in cases.items():
                ms = device_ms(torch, run, PROFILED[kernel])
                times[label][case].append(ms)
                print(f"round {rnd} {label}, {case}: {ms:.4f} ms (device time, profiler)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30).stdout.strip()
    print(json.dumps({"kernel": kernel, "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                      "registers": {label: regs for label, (_, regs) in built.items()}, "ms": times,
                      "disagreements": failed}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
