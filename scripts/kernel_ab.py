#!/usr/bin/env python3
"""A kernel of this tree against other sources of it, on one NVIDIA GPU.

    python3 scripts/kernel_ab.py KERNEL [--no-gate] LABEL=CSRC_DIR [LABEL=CSRC_DIR ...]

KERNEL is ``sweep``, ``exchange``, ``energy`` or ``sweep_energy``. Builds ``csrc/KERNEL.cu`` of the
package ("change") and of each given source directory (the exchange kernel:
``exchange.cu`` and ``exchange_tempered.cu``, its tempered instances, or,
where a directory has no ``exchange_tempered.cu``, its ``exchange.cu`` for
both, as before the two were split) (for example an
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
  n_beta = 4 (the tempered instance with its swap phases);
- ``energy``: ``ops.energy.offdiag_sum_cuda`` on the LITFI flagship's inputs
  (as ``sweep``, weights scaled alike), the float32 instances and the
  float64 ones (the same inputs in complex128);
- ``sweep_energy``: the megakernel A/B's inputs (``megakernel_ab.py``:
  ``RBMTrSymm(64, alpha)`` at alpha 1, 4 and 8, H = 64, 256 and 512, its
  init weights, the LITFI chain's Neel start, K=8192, one sweep on caller
  uniforms) at n_beta = 1 and 8: ``ops.sweep_energy.sweeps_offdiag_cuda``,
  and beside it in the same rounds its A/B's other arm, the package's sweep
  kernel then its energy kernel (one case each, timed as the sum of the two
  kernels' device times a call). A build whose megakernel has the C
  interface it had before its factor form (the energy kernel's (N, H, 4)
  table, nothing after the stream: an earlier commit's source) is launched
  through that interface.

A case whose C function a build does not export (the float64 energy
instances before their tiled design, ``nqs_offdiag_f64``, read another
table) is reported as absent from that build and not run on it.

Each build is first held against the plain version on the same stream
(sweep, exchange: the share of walkers with other decisions, or near the
log-cosh's branch cut with c, at most 1e-3; y within 1e-5 on the others;
energy: max|kernel - plain| / max|plain| at most 1e-5 in float32, over the
walkers away from the cut with c, and 1e-12 in float64 over all;
sweep_energy: the sweep's bars, and the sums as the energy's in float32 on
the walkers with the same decisions), and
whether its output equals the "change" build's bit for bit (float64
energy: its relative difference) is printed; with ``--no-gate`` a build
that disagrees is reported and timed all the same (an ablation, whose
builds have parts of the kernel taken out, ``energy_f64_ablation.py``).
Then each is timed by
``torch.profiler`` (the kernel's device time a call, mean of 20 calls) in
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
from typing import Callable, NamedTuple

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SCALE, REPS = 10.0, 20  # weights scaled as chip_smoke.py's comparisons scale them; launches per timing
MISMATCH_MAX, Y_ATOL = 1e-3, 1e-5
ENERGY_RTOL, F64_ENERGY_RTOL = 1e-5, 1e-12  # the energy kernel's bars (chip_smoke.py)


class Spec(NamedTuple):
    entries: dict  # {kernel name: (template flags, suffix)}, for the registers
    shown: tuple  # the instances (their template integers) whose registers are printed
    cases: dict  # {case: (kernel call, plain call)}
    check: Callable  # (case, kernel output, plain output) -> (ok, text)
    same: Callable  # (case, output, the change build's output) -> text
    libraries: tuple = ()  # the package's libraries of the kernel (default: KERNEL alone)
    timed: tuple = ()  # the kernel names whose device times a call sums (default: the first of entries)
    on_load: Callable | None = None  # called with a build's source directory once it is loaded


def parse_registers(log: str, entries: dict[str, tuple[str, str]]) -> dict[str, str]:
    """{instance: registers(+spill bytes)} from ``ptxas -v`` for each kernel
    name of ``entries`` ({name: (flags, suffix)}): an instance is its template
    integers joined by "x", the letters of ``flags`` whose template bools are
    set (sweep: c, t, m; exchange: c, t; energy: c), then the suffix (the
    energy kernel's float64 instances: d)."""
    regs, key, spill = {}, None, 0
    for line in log.splitlines():
        found = [(name, m) for name in entries if (m := re.search(rf"{name}I((?:Li\d+E)*)((?:Lb\dE)*)E", line))]
        if "Compiling entry function" in line and found:
            name, m = found[0]
            flags, suffix = entries[name]
            ints = re.findall(r"Li(\d+)E", m.group(1))
            bools = re.findall(r"Lb(\d)E", m.group(2))
            key, spill = "x".join(ints) + "".join(f for f, v in zip(flags, bools) if v == "1") + suffix, 0
        elif key is not None and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif key is not None and "registers" in line:
            regs[key] = re.search(r"Used (\d+) registers", line).group(1) + (f"+{spill}B" if spill else "")
            key = None
    return regs


def build_all(build, kernel: str, libraries: tuple, sources: dict[str, Path], entries: dict[str, tuple[str, str]]):
    """{label: ({library: path}, {instance: registers})}, every build started
    at once: each of `libraries` from its own source where the directory
    has one, else from ``KERNEL.cu`` (built once, serving them all)."""
    out_dir = build.BUILD_DIR / f"{kernel}_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, src in sources.items():
        for name in libraries:
            source = src / f"{name}.cu" if (src / f"{name}.cu").exists() else src / f"{kernel}.cu"
            lib = out_dir / f"{source.stem}_{label}.so"
            if (label, lib) not in procs:
                cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(source)]
                procs[label, lib] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {}
    for (label, lib), proc in procs.items():
        log, _ = proc.communicate(timeout=build.NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            raise SystemExit(f"kernel_ab: nvcc failed for {label} ({lib.name}):\n{log}")
        logs[label, lib] = log
    built = {}
    for label, src in sources.items():
        libs = {}
        for name in libraries:
            source = src / f"{name}.cu" if (src / f"{name}.cu").exists() else src / f"{kernel}.cu"
            libs[name] = out_dir / f"{source.stem}_{label}.so"
        regs = {}
        for lib in set(libs.values()):
            regs |= parse_registers(logs[label, lib], entries)
        built[label] = (libs, regs)
    return built


def _check_states(torch, near_branch_cut):
    """Sweep and exchange: (ok, text) of a kernel's states against the plain
    version's, and whether two outputs are equal to the bit."""
    def check(case, out, want):
        (ck, _, _), (cp, _, _) = out, want
        differ = (ck.spins != cp.spins).any(dim=1)
        if case.startswith("c,"):
            differ |= near_branch_cut(ck.y) | near_branch_cut(cp.y)
        share, dy = float(differ.double().mean()), float((ck.y[~differ] - cp.y[~differ]).abs().max())
        return (share <= MISMATCH_MAX and dy <= Y_ATOL,
                f"other decisions than the plain version {share:.2e} (max {MISMATCH_MAX:.0e}), "
                f"max|dy| {dy:.2e} (tol {Y_ATOL:.0e})")

    def same(case, out, ref):
        def flat(o):
            return (o[0].spins, o[0].y, o[0].sa, o[1], torch.as_tensor(o[2]))
        return f"bitwise equal to change: {all(torch.equal(a, b) for a, b in zip(flat(out), flat(ref)))}"

    return check, same


def _flagship_works(torch, g):
    """The LITFI flagship's RBMTrSymm(64, alpha=4) and FFNN(64, 256), weights
    scaled as chip_smoke.py's comparisons scale them (the FFNN's imaginary
    planes alone)."""
    from neural_network_quantum_state_tpu_torch.models import FFNN, RBMTrSymm

    n, alpha = 64, 4
    rbm, ffnn = RBMTrSymm(n_inputs=n, alpha=alpha, dtype=torch.float32), FFNN(n_inputs=n, n_hiddens=n * alpha,
                                                                              dtype=torch.float32)
    return {"rbm": rbm.make_work({k_: SCALE * v for k_, v in rbm.init_params(g).items()}),
            "c": ffnn.make_work({k_: torch.complex(v.real, SCALE * v.imag) for k_, v in ffnn.init_params(g).items()})}


def sweep_spec(torch, g):
    from neural_network_quantum_state_tpu_torch.hamiltonians import LITFIChain
    from neural_network_quantum_state_tpu_torch.ops import engine
    from neural_network_quantum_state_tpu_torch.ops import sweep as sweep_ops
    from neural_network_quantum_state_tpu_torch.ops.logcosh import near_branch_cut
    from neural_network_quantum_state_tpu_torch.ops.rng import PhiloxDraws, philox_key, random_spins

    n, k = 64, 8192
    sched = torch.as_tensor(LITFIChain(n_sites=n).schedule())
    cases = {}
    for kind, work in _flagship_works(torch, g).items():
        cache, ln = engine.full_forward(work, random_spins(g, k, n))
        for sweeps, nb in ((1, 1), (5, 1), (1, 8)):
            draws = PhiloxDraws(philox_key(g), sweeps * n)
            cases[f"{kind}, {sweeps} sweeps, n_beta={nb}"] = (
                lambda w=work, c=cache, d=draws, b=nb: sweep_ops.sweep_cuda(w, c, sched, d, b),
                lambda w=work, c=cache, l_=ln, d=draws, b=nb: sweep_ops.sweep_plain(w, c, l_, sched, d, b))
    return Spec({"sweep_kernel": ("ctm", "")}, ("8",), cases, *_check_states(torch, near_branch_cut))


def exchange_spec(torch, g):
    from neural_network_quantum_state_tpu_torch.hamiltonians import HubbardChain
    from neural_network_quantum_state_tpu_torch.models import FFNN, RBM
    from neural_network_quantum_state_tpu_torch.ops import engine
    from neural_network_quantum_state_tpu_torch.ops import exchange as exchange_ops
    from neural_network_quantum_state_tpu_torch.ops.logcosh import near_branch_cut
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
    return Spec({"exchange_kernel": ("ct", "")}, ("8x8", "32x16"), cases, *_check_states(torch, near_branch_cut),
                libraries=("exchange", "exchange_tempered"))


def energy_spec(torch, g):
    from neural_network_quantum_state_tpu_torch.ops import energy, engine
    from neural_network_quantum_state_tpu_torch.ops.rng import random_spins

    n, k = 64, 8192
    cases, near = {}, {}
    for kind, work in _flagship_works(torch, g).items():
        cache, ln = engine.full_forward(work, random_spins(g, k, n))
        w64 = engine.Work(*(None if t is None else t.to(torch.complex128) for t in work))
        c64, l64 = engine.full_forward(w64, cache.spins.double())
        cases[f"{kind} f32"] = (lambda w=work, c=cache: energy.offdiag_sum_cuda(w, c),
                                lambda w=work, c=cache, l_=ln: energy.offdiag_sum_plain(w, c, l_))
        cases[f"{kind} f64"] = (lambda w=w64, c=c64: energy.offdiag_sum_cuda(w, c),
                                lambda w=w64, c=c64, l_=l64: energy.offdiag_sum_plain(w, c, l_))
        near[f"{kind} f32"] = (energy.offdiag_near_cut(work, cache) if work.c is not None
                               else torch.zeros(k, dtype=torch.bool, device=g.device))

    def check(case, out, want):
        tol = F64_ENERGY_RTOL if case.endswith("f64") else ENERGY_RTOL
        far = ~near.get(case, torch.zeros(k, dtype=torch.bool, device=g.device))
        rel = float((out - want)[far].abs().max() / want[far].abs().max())
        return rel <= tol, f"max|kernel-plain| / max|plain| {rel:.3e} (tol {tol:.0e}) over {int(far.sum())} walkers"

    def same(case, out, ref):
        if case.endswith("f64"):
            return f"relative difference to change {float((out - ref).abs().max() / ref.abs().max()):.3e}"
        return f"bitwise equal to change: {torch.equal(out, ref)}"

    # the flagship's R = 8 float32 instances; the float64 ones (one per family)
    return Spec({"offdiag_kernel": ("c", ""), "offdiag_kernel_f64": ("c", "d")}, ("8", ""), cases, check, same)


def _megakernel_before_factor_form(torch, work, cache, sched, u, n_beta, u_swap):
    """The megakernel through the C interface it had before its factor form
    (the energy kernel's (N, H, 4) table and out after the stats, nothing
    after the stream), on caller uniforms; returns what
    ``sweeps_offdiag_cuda`` returns."""
    import ctypes

    from neural_network_quantum_state_tpu_torch.ops import build, engine

    k, n = cache.spins.shape
    fn = build.library("sweep_energy").nqs_sweep_offdiag_f32
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _, weights = engine.kernel_weights(work)
    spins, y, sa = torch.empty_like(cache.spins), torch.empty_like(cache.y), torch.empty_like(cache.sa)
    stats = torch.empty((2, k), dtype=torch.int32, device=u.device)
    out = torch.empty(k, dtype=torch.complex64, device=u.device)
    rc = build.launch(u.device, fn, *weights, cache.spins.data_ptr(), cache.y.data_ptr(), cache.sa.data_ptr(),
                      sched.data_ptr(), u.data_ptr(), None if u_swap is None else u_swap.data_ptr(), None,
                      spins.data_ptr(), y.data_ptr(), sa.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
                      engine.kernel_table(work.w).data_ptr(), out.data_ptr(), k, n, work.w.shape[1],
                      sched.shape[0], u.shape[0], n_beta, torch.cuda.current_stream(u.device).cuda_stream)
    build.check_launch(rc, "sweep_energy kernel (before its factor form)")
    new = engine.Cache(spins=spins, y=y, sa=sa)
    return new, engine.cache_log_psi(work, new), stats[0].sum(dtype=torch.float64), out


def sweep_energy_spec(torch, g):
    from neural_network_quantum_state_tpu_torch.hamiltonians import LITFIChain
    from neural_network_quantum_state_tpu_torch.models import RBMTrSymm
    from neural_network_quantum_state_tpu_torch.ops import energy, engine
    from neural_network_quantum_state_tpu_torch.ops import sweep as sweep_ops
    from neural_network_quantum_state_tpu_torch.ops.rng import uniform_block
    from neural_network_quantum_state_tpu_torch.ops.sweep_energy import sweeps_offdiag_cuda, sweeps_offdiag_plain

    n, k = 64, 8192
    ham = LITFIChain(n_sites=n, h=-0.5, j=0.866, alpha=2.5, pbc=True)
    sched = torch.as_tensor(ham.schedule(), dtype=torch.int32, device=g.device)
    interface = {"before_factor_form": False}

    def on_load(src: Path) -> None:  # the build's C interface, from its source
        text = (src / "sweep_energy.cu").read_text()
        interface["before_factor_form"] = re.search(r"nqs_sweep_offdiag_f32\([^)]*\bnarrow\)", text) is None

    def megakernel(work, cache, u, nb, us):
        if interface["before_factor_form"]:
            return _megakernel_before_factor_form(torch, work, cache, sched, u, nb, us)
        return sweeps_offdiag_cuda(work, cache, sched, u, nb, us)

    def two_kernels(work, cache, u, nb, us):
        c2, l2, acc = sweep_ops.sweep_cuda(work, cache, sched, u, nb, us)
        return c2, l2, acc, energy.offdiag_sum_cuda(work, c2)

    cases = {}
    for alpha in (1, 4, 8):
        machine = RBMTrSymm(n_inputs=n, alpha=alpha, dtype=torch.float32)
        work = machine.make_work(machine.init_params(g))
        cache, ln = engine.full_forward(work, ham.init_spins(g, k))
        for nb in (1, 8):
            u, us = uniform_block(g, (n, k)), uniform_block(g, (1, 2, k)) if nb > 1 else None
            args = (work, cache, u, nb, us)

            def plain(w=work, c=cache, l_=ln, u_=u, b=nb, s_=us):
                return sweeps_offdiag_plain(w, c, l_, sched, u_, b, s_)

            cases[f"H={n * alpha}, n_beta={nb}, megakernel"] = (lambda a=args: megakernel(*a), plain)
            cases[f"H={n * alpha}, n_beta={nb}, two kernels"] = (lambda a=args: two_kernels(*a), plain)

    def check(case, out, want):
        (ck, _, _, ok_), (cp, _, _, op) = out, want
        same = (ck.spins == cp.spins).all(dim=1)
        share, dy, rel = 1.0 - float(same.double().mean()), float("inf"), float("inf")
        if bool(same.any()):  # (an ablation may part from the plain version on every walker)
            dy = float((ck.y[same] - cp.y[same]).abs().max())
            rel = float((ok_[same] - op[same]).abs().max() / op[same].abs().max())
        return (share <= MISMATCH_MAX and dy <= Y_ATOL and rel <= ENERGY_RTOL,
                f"other decisions than the plain version {share:.2e} (max {MISMATCH_MAX:.0e}), max|dy| {dy:.2e} "
                f"(tol {Y_ATOL:.0e}), sums max|kernel-plain| / max|plain| {rel:.3e} (tol {ENERGY_RTOL:.0e})")

    def same(case, out, ref):
        def flat(o):
            return (o[0].spins, o[0].y, o[0].sa, o[3])
        return f"bitwise equal to change: {all(torch.equal(a, b) for a, b in zip(flat(out), flat(ref)))}"

    # this tree's instances at H = 64, 256, 512 (lanes x words) and an earlier source's (R = ceil(H/32))
    return Spec({"sweep_energy_kernel": ("t", "")}, ("16x4", "32x8", "32x16", "2", "8", "16"), cases, check, same,
                timed=("sweep_energy_kernel", "sweep_kernel", "offdiag_kernel"), on_load=on_load)


SPECS = {"sweep": sweep_spec, "exchange": exchange_spec, "energy": energy_spec, "sweep_energy": sweep_energy_spec}


def main(argv: list[str] | None = None) -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    argv = sys.argv[1:] if argv is None else argv
    gate = "--no-gate" not in argv
    argv = [a for a in argv if a != "--no-gate"]
    if not argv or argv[0] not in SPECS:
        print(f"usage: kernel_ab.py {{{','.join(SPECS)}}} [--no-gate] LABEL=CSRC_DIR ...", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    from neural_network_quantum_state_tpu_torch.ops import build
    from neural_network_quantum_state_tpu_torch.ops.rng import make_generator

    kernel = argv[0]
    sources = {"change": build.CSRC_DIR}
    for arg in argv[1:]:
        label, _, path = arg.partition("=")
        sources[label] = Path(path)
    g = make_generator(7, torch.device("cuda"))
    spec = SPECS[kernel](torch, g)
    built = build_all(build, kernel, spec.libraries or (kernel,), sources, spec.entries)
    timed = spec.timed or (next(iter(spec.entries)),)  # substrings of the timed kernels' names

    def device_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and any(t in e.key for t in timed)]
        return sum(e.self_device_time_total for e in evs) / 1e3 / REPS

    def load(label):
        for name, lib in built[label][0].items():
            build.load(name, lib)
        if spec.on_load:
            spec.on_load(sources[label])

    reference, absent = {}, set()
    for label, (libs, regs) in built.items():
        load(label)
        for case, (run, plain) in spec.cases.items():
            try:
                out = run()
            except AttributeError as err:  # ctypes: the build exports no such function
                print(f"{label} ({case}): absent from this build ({err})")
                absent.add((label, case))
                continue
            ok, text = spec.check(case, out, plain())
            print(f"{label} ({case}): {text}; {spec.same(case, out, reference.setdefault(case, out))}")
            if not ok and gate:
                raise SystemExit(f"kernel_ab: {label} ({case}) disagrees with the plain version")
        regs = ", ".join(f"{k} {v}" for k, v in sorted(regs.items())
                         if re.match(rf"({'|'.join(spec.shown)})[a-z]*$", k))
        print(f"{label}: registers (+spill bytes) of the {'/'.join(s or 'any R' for s in spec.shown)} instances: "
              f"{regs}", flush=True)

    times: dict[str, list[float]] = {}
    order = list(built)
    for labels in (order, order[::-1], order, order[::-1]):
        for label in labels:
            load(label)
            for case, (run, _) in spec.cases.items():
                if (label, case) in absent:
                    continue
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
