#!/usr/bin/env python3
"""The exchange kernel's measured choices against their alternatives, on one NVIDIA GPU.

    python3 scripts/exchange_ablation.py

Builds ``csrc/exchange.cu`` as the package builds it and once with each
measurement switch of its header (``-D``, one ``nvcc`` process per build, all
started together) into the port's gitignored build directory. Each build in
turn is loaded as the package's exchange library (``ops.build.load``) and
driven through ``ops.exchange.exchange_cuda`` at the Hubbard flagship's
exchange: the L=32 trap chain (N=64, B=64 bonds), K=4096 walkers,
RBM(64, 64) and FFNN(64, 64) (the instance with c), 64 and 320 proposals in
one launch on the kernel's Philox stream. Every switch keeps the
computation, so each build is first held against the plain exchange on the
same stream (the share of walkers with other decisions at most 1e-3, y
within 1e-5 on the others); then each is timed by ``torch.profiler`` (the
kernel's device time, mean of 20 launches), in two rounds, the second in
the reverse order. Prints one line per build with the registers and spill
bytes of its instances at H = 64 (``ptxas -v``), one line per timing, a JSON object of
the times, and the card's name and power limit. Exits 1 without a CUDA
device or on a disagreement. Imports no JAX.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# build name: the -D switches (exchange.cu's header says what each does)
VARIANTS = {
    "default": (),
    "lanes4": ("NQS_EXCHANGE_LANES=4",),
    "lanes16": ("NQS_EXCHANGE_LANES=16",),
    "lanes32": ("NQS_EXCHANGE_LANES=32",),
    "w_l1": ("NQS_EXCHANGE_W_L1",),
    "fns": ("NQS_EXCHANGE_FNS",),
    "c_sincos": ("NQS_EXCHANGE_C_SINCOS",),
    "min_blocks1": ("NQS_EXCHANGE_MIN_BLOCKS=1",),
    "min_blocks3": ("NQS_EXCHANGE_MIN_BLOCKS=3",),
    "min_blocks4": ("NQS_EXCHANGE_MIN_BLOCKS=4",),
}
STEPS, REPS, K, H, L = (64, 320), 20, 4096, 64, 32
MISMATCH_MAX, Y_ATOL = 1e-3, 1e-5


def build_all(build) -> dict[str, tuple[Path, str]]:
    """{name: (library, registers and spill bytes of the instances that run
    at H = 64: G = 8 lanes per walker, or the forced G, with and without c)}."""
    out_dir = build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, defines in VARIANTS.items():
        lib = out_dir / f"exchange_{name}.so"
        cmd = [build.nvcc(), *build.NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", str(lib),
               str(build.CSRC_DIR / "exchange.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    built = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate(timeout=build.NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            raise SystemExit(f"exchange_ablation: nvcc failed for {name}:\n{log}")
        lanes = next((int(d.split("=")[1]) for d in VARIANTS[name] if d.startswith("NQS_EXCHANGE_LANES=")), 8)
        want, found, entry, spill = (str(lanes), str(H // lanes)), {}, None, 0
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = re.search(r"exchange_kernelILi(\d+)ELi(\d+)ELb(\d)E", line)
            elif entry and entry.group(1, 2) == want and "spill stores" in line:
                spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
            elif entry and entry.group(1, 2) == want and "registers" in line:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                found["with c" if entry.group(3) == "1" else "RBM"] = regs + (f"+{spill}B" if spill else "")
                entry = None
        built[name] = (lib, f"G = {lanes}, U = {H // lanes}: " + ", ".join(f"{k} {v}" for k, v in sorted(found.items())))
    return built


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("exchange_ablation: no CUDA device", file=sys.stderr)
        return 1
    from neural_network_quantum_state_tpu_torch.hamiltonians import HubbardChain
    from neural_network_quantum_state_tpu_torch.models import FFNN, RBM
    from neural_network_quantum_state_tpu_torch.ops import build, engine
    from neural_network_quantum_state_tpu_torch.ops import exchange as exchange_ops
    from neural_network_quantum_state_tpu_torch.ops.rng import ExchangeDraws, make_generator, philox_key

    built = build_all(build)
    dev = torch.device("cuda")
    g = make_generator(5, dev)
    hub = HubbardChain(n_sites=2 * L, n_up=5, n_down=5)
    bonds = torch.as_tensor(hub.bonds, device=dev)
    rbm, ffnn = RBM(n_inputs=2 * L, n_hiddens=H), FFNN(n_inputs=2 * L, n_hiddens=H, dtype=torch.float32)
    # weights scaled as chip_smoke.py's comparisons scale them: |y| ~ 0.5 in both planes
    works = {"rbm": rbm.make_work({k: 10.0 * v for k, v in rbm.init_params(g).items()}),
             "c": ffnn.make_work({k: torch.complex(v.real, 10.0 * v.imag) for k, v in ffnn.init_params(g).items()})}
    states = {kind: engine.full_forward(w, hub.init_spins(g, K)) for kind, w in works.items()}

    def device_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and "exchange_kernel" in e.key]
        return sum(e.self_device_time_total for e in evs) / 1e3 / sum(e.count for e in evs)

    for name, (lib, regs) in built.items():
        build.load("exchange", lib)
        for kind, work in works.items():
            cache, ln = states[kind]
            draws = ExchangeDraws(philox_key(g), STEPS[-1])
            ck, _, _ = exchange_ops.exchange_cuda(work, cache, bonds, draws)
            cp, _, _ = exchange_ops.exchange_plain(work, cache, ln, bonds, draws)
            same = (ck.spins == cp.spins).all(dim=1)
            share, dy = 1.0 - float(same.double().mean()), float((ck.y[same] - cp.y[same]).abs().max())
            print(f"{name} ({kind}): other decisions than the plain exchange {share:.2e} (max {MISMATCH_MAX:.0e}), "
                  f"max|dy| {dy:.2e} (tol {Y_ATOL:.0e}), {STEPS[-1]} proposals")
            if not (share <= MISMATCH_MAX and dy <= Y_ATOL):
                raise SystemExit(f"exchange_ablation: {name} ({kind}) disagrees with the plain exchange")
        print(f"{name}: registers (+spill bytes) {regs}", flush=True)

    times: dict[str, list[float]] = {}
    for names in (list(built), list(built)[::-1]):
        for name in names:
            build.load("exchange", built[name][0])
            for kind, work in works.items():
                cache, _ = states[kind]
                for steps in STEPS:
                    draws = ExchangeDraws(philox_key(g), steps)
                    ms = device_ms(lambda: exchange_ops.exchange_cuda(work, cache, bonds, draws))
                    times.setdefault(f"{name} {kind} {steps}", []).append(ms)
                    print(f"{name} ({kind}, {steps} proposals): kernel {ms:.4f} ms", flush=True)
    print(json.dumps({"exchange_ablation_ms": times}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
