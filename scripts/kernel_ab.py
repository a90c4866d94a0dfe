#!/usr/bin/env python3
"""A kernel of this tree against other sources of it, on one NVIDIA GPU.

    python3 scripts/kernel_ab.py KERNEL LABEL=CSRC_DIR [LABEL=CSRC_DIR ...]

KERNEL is ``sweep`` or ``exchange``. Builds ``csrc/KERNEL.cu`` of the
package ("change") and of each given source directory (for example an
earlier commit's ``neural_network_quantum_state_tpu_torch/csrc``, unpacked
with ``git archive``), one ``nvcc`` process per build, all started together,
into the port's gitignored build directory. The builds must share the
package's C interface: each build in turn is loaded as the package's library
of that kernel (``ops.build.load``) and driven through the package's wrapper
on the kernel's Philox stream, each case on the RBM family and on the
instance with output weights c:

- ``sweep``: ``ops.sweep.sweep_cuda`` at the LITFI flagship's width (N=64,
  H=256, K=8192; ``RBMTrSymm(64, alpha=4)``, ``FFNN(64, 256)``), one sweep
  and five sweeps in one launch at n_beta = 1, one sweep at n_beta = 8;
- ``exchange``: ``ops.exchange.exchange_cuda`` at the Hubbard flagship's
  (L=32: N=64, H=64, K=4096, B=64; ``RBM(64, 64)``, ``FFNN(64, 64)``), one
  and five sweeps of 64 proposals in one launch at n_beta = 1 and at
  n_beta = 4 (the tempered instance with its swap phases).

Each build is first held against the plain version on the same stream (the
share of walkers with other decisions, or near the log-cosh's branch cut
with c, at most 1e-3; y within 1e-5 on the others), and whether its output
equals the "change" build's bit for bit is printed. Then each is timed by
``torch.profiler`` (the kernel's device time, mean of 20 launches) in
rounds that alternate the order: the builds, the builds reversed, the
builds, the builds reversed. Prints the registers and spill bytes of the
instances the cases run at these widths (``ptxas -v``), one line per
timing, a JSON object of the times, and the card's name and power limit.
Exits 1 without a CUDA device or on a disagreement. Imports no JAX.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SCALE, REPS = 10.0, 20  # weights scaled as chip_smoke.py's comparisons scale them; launches per timing
MISMATCH_MAX, Y_ATOL = 1e-3, 1e-5


def parse_registers(log: str, entry: str, flags: str) -> dict[str, str]:
    """{instance: registers(+spill bytes)} from ``ptxas -v``: an instance is
    its template integers joined by "x", then the letters of ``flags`` whose
    template bools are set (sweep: c, t, m; exchange: c, t)."""
    regs, key, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(rf"{entry}I((?:Li\d+E)+)((?:Lb\dE)*)E", line)
        if "Compiling entry function" in line and m:
            ints = re.findall(r"Li(\d+)E", m.group(1))
            bools = re.findall(r"Lb(\d)E", m.group(2))
            key, spill = "x".join(ints) + "".join(f for f, v in zip(flags, bools) if v == "1"), 0
        elif key is not None and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif key is not None and "registers" in line:
            regs[key] = re.search(r"Used (\d+) registers", line).group(1) + (f"+{spill}B" if spill else "")
            key = None
    return regs


def build_all(build, kernel: str, sources: dict[str, Path], entry: str, flags: str):
    """{label: (library, {instance: registers})}, every build started at once."""
    out_dir = build.BUILD_DIR / f"{kernel}_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, src in sources.items():
        lib = out_dir / f"{kernel}_{label}.so"
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src / f"{kernel}.cu")]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    built = {}
    for label, (proc, lib) in procs.items():
        log, _ = proc.communicate(timeout=build.NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            raise SystemExit(f"kernel_ab: nvcc failed for {label}:\n{log}")
        built[label] = (lib, parse_registers(log, entry, flags))
    return built


def sweep_spec(torch, g):
    """(entry, flags, instances to print, {case: (kernel call, plain call)})."""
    from neural_network_quantum_state_tpu_torch.hamiltonians import LITFIChain
    from neural_network_quantum_state_tpu_torch.models import FFNN, RBMTrSymm
    from neural_network_quantum_state_tpu_torch.ops import engine
    from neural_network_quantum_state_tpu_torch.ops import sweep as sweep_ops
    from neural_network_quantum_state_tpu_torch.ops.rng import PhiloxDraws, philox_key, random_spins

    n, alpha, k = 64, 4, 8192
    rbm, ffnn = RBMTrSymm(n_inputs=n, alpha=alpha, dtype=torch.float32), FFNN(n_inputs=n, n_hiddens=n * alpha,
                                                                              dtype=torch.float32)
    works = {"rbm": rbm.make_work({k_: SCALE * v for k_, v in rbm.init_params(g).items()}),
             "c": ffnn.make_work({k_: torch.complex(v.real, SCALE * v.imag) for k_, v in ffnn.init_params(g).items()})}
    sched = torch.as_tensor(LITFIChain(n_sites=n).schedule())
    cases = {}
    for kind, work in works.items():
        cache, ln = engine.full_forward(work, random_spins(g, k, n))
        for sweeps, nb in ((1, 1), (5, 1), (1, 8)):
            draws = PhiloxDraws(philox_key(g), sweeps * n)
            cases[f"{kind}, {sweeps} sweeps, n_beta={nb}"] = (
                lambda w=work, c=cache, d=draws, b=nb: sweep_ops.sweep_cuda(w, c, sched, d, b),
                lambda w=work, c=cache, l_=ln, d=draws, b=nb: sweep_ops.sweep_plain(w, c, l_, sched, d, b))
    return "sweep_kernel", "ctm", ("8",), cases


def exchange_spec(torch, g):
    """(entry, flags, instances to print, {case: (kernel call, plain call)})."""
    from neural_network_quantum_state_tpu_torch.hamiltonians import HubbardChain
    from neural_network_quantum_state_tpu_torch.models import FFNN, RBM
    from neural_network_quantum_state_tpu_torch.ops import engine
    from neural_network_quantum_state_tpu_torch.ops import exchange as exchange_ops
    from neural_network_quantum_state_tpu_torch.ops.rng import ExchangeDraws, philox_key

    n, h, k = 64, 64, 4096
    ham = HubbardChain(n_sites=n, u=4.0, t=1.0, n_up=5, n_down=5, pbc=True)
    rbm, ffnn = RBM(n_inputs=n, n_hiddens=h), FFNN(n_inputs=n, n_hiddens=h, dtype=torch.float32)
    works = {"rbm": rbm.make_work({k_: SCALE * v for k_, v in rbm.init_params(g).items()}),
             "c": ffnn.make_work({k_: torch.complex(v.real, SCALE * v.imag) for k_, v in ffnn.init_params(g).items()})}
    bonds = torch.as_tensor(ham.bonds, dtype=torch.int32, device=g.device)
    n_unit = ham.n_unit_steps
    cases = {}
    for kind, work in works.items():
        cache, ln = engine.full_forward(work, ham.init_spins(g, k))
        for sweeps, nb in ((1, 1), (5, 1), (1, 4), (5, 4)):
            draws = ExchangeDraws(philox_key(g), sweeps * n_unit)
            cases[f"{kind}, {sweeps} sweeps, n_beta={nb}"] = (
                lambda w=work, c=cache, d=draws, b=nb: exchange_ops.exchange_cuda(w, c, bonds, d, n_beta=b,
                                                                                  n_unit=n_unit),
                lambda w=work, c=cache, l_=ln, d=draws, b=nb: exchange_ops.tempered_exchange_plain(
                    w, c, l_, bonds, d, None, b, n_unit))
    # G x U of the flagship (8 x 8) and of the widest instances (32 x 16)
    return "exchange_kernel", "ct", ("8x8", "32x16"), cases


SPECS = {"sweep": sweep_spec, "exchange": exchange_spec}


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if len(sys.argv) < 2 or sys.argv[1] not in SPECS:
        print(f"usage: kernel_ab.py {{{','.join(SPECS)}}} LABEL=CSRC_DIR ...", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    from neural_network_quantum_state_tpu_torch.ops import build
    from neural_network_quantum_state_tpu_torch.ops.logcosh import near_branch_cut
    from neural_network_quantum_state_tpu_torch.ops.rng import make_generator

    kernel = sys.argv[1]
    sources = {"change": build.CSRC_DIR}
    for arg in sys.argv[2:]:
        label, _, path = arg.partition("=")
        sources[label] = Path(path)
    g = make_generator(7, torch.device("cuda"))
    entry, flags, shown, cases = SPECS[kernel](torch, g)
    built = build_all(build, kernel, sources, entry, flags)

    def device_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and entry in e.key]
        return sum(e.self_device_time_total for e in evs) / 1e3 / sum(e.count for e in evs)

    reference = {}
    for label, (lib, regs) in built.items():
        build.load(kernel, lib)
        for case, (run, plain) in cases.items():
            ck, lk, acc_k = run()
            cp, _, _ = plain()
            differ = (ck.spins != cp.spins).any(dim=1)
            if case.startswith("c,"):
                differ |= near_branch_cut(ck.y) | near_branch_cut(cp.y)
            share, dy = float(differ.double().mean()), float((ck.y[~differ] - cp.y[~differ]).abs().max())
            out = (ck.spins, ck.y, ck.sa, lk, torch.as_tensor(acc_k))
            want = reference.setdefault(case, out)
            same = all(torch.equal(a, b) for a, b in zip(out, want))
            print(f"{label} ({case}): other decisions than the plain version {share:.2e} (max {MISMATCH_MAX:.0e}), "
                  f"max|dy| {dy:.2e} (tol {Y_ATOL:.0e}); bitwise equal to change: {same}")
            if not (share <= MISMATCH_MAX and dy <= Y_ATOL):
                raise SystemExit(f"kernel_ab: {label} ({case}) disagrees with the plain version")
        regs = ", ".join(f"{k} {v}" for k, v in sorted(regs.items()) if re.match(rf"({'|'.join(shown)})[a-z]*$", k))
        print(f"{label}: registers (+spill bytes) of the {'/'.join(shown)} instances: {regs}", flush=True)

    times: dict[str, list[float]] = {}
    order = list(built)
    for labels in (order, order[::-1], order, order[::-1]):
        for label in labels:
            build.load(kernel, built[label][0])
            for case, (run, _) in cases.items():
                ms = device_ms(run)
                times.setdefault(f"{label} {case}", []).append(ms)
                print(f"{label} ({case}): kernel {ms:.4f} ms", flush=True)
    print(json.dumps({f"{kernel}_ab_ms": times}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
