"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` for Hopper (``sm_90a``) into ``build/<name>-<hash>.so`` at first
use and loaded with ``ctypes``; the hash of the source and of every shared
header ``csrc/*.cuh`` is in the file name, so an edited source or header is
rebuilt and a stale library is never loaded. Nothing here runs at import
time: this module imports on a machine without CUDA.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
KERNELS = ("sweep", "energy", "exchange", "sweep_energy", "chain_rate")
# The kernels instantiate R = ceil(H/32) = 1..16 words of hidden units per
# lane and mask the tail, so they take any 1 <= H <= MAX_HIDDEN; sweep,
# energy and exchange do so once without and once with output weights c, and
# the sweep, the megakernel and the exchange once for n_beta = 1 and once for
# n_beta > 1. chain_rate is the benchmark's probe of their arithmetic.
MAX_HIDDEN = 512
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
NVCC_TIMEOUT_S = 240

_loaded: dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass(frozen=True)
class Built:
    name: str
    path: Path
    seconds: float  # 0.0 when an up-to-date library was already on disk
    ptxas: tuple[str, ...]  # ptxas -v lines: entry function, registers, spills


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")
    return found


def _target(name: str) -> Path:
    digest = hashlib.sha256()
    for src in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def build(names=KERNELS) -> dict[str, Built]:
    """Compile the named kernels, one ``nvcc`` process per source, all started
    together. Raises RuntimeError with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, {}
    try:
        for name in names:
            target = _target(name)
            if target.exists():
                out[name] = Built(name, target, 0.0, ())
                continue
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                           time.perf_counter(), tmp, target)
        for name, (proc, t0, tmp, target) in procs.items():
            log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
            os.replace(tmp, target)
            keys = ("Compiling entry function", "registers", "spill")
            ptxas = tuple(ln.strip() for ln in log.splitlines() if any(key in ln for key in keys))
            out[name] = Built(name, target, seconds, ptxas)
    finally:
        for proc, *_ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build([name])[name].path))
    return _loaded[name]


def load(name: str, path) -> ctypes.CDLL:
    """Load the library at `path` as kernel `name` from now on, in place of
    the package's build: a build of the source with a measurement switch."""
    _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]


def check_inputs(kernel: str, device, hidden: int, tensors: dict) -> None:
    """Raise unless every ``name: (tensor, dtype, shape)`` is a contiguous
    tensor of that dtype and shape on the CUDA `device`, and the hidden
    count is one the kernel is built for (1 to MAX_HIDDEN)."""
    if device.type != "cuda":
        raise ValueError(f"{kernel} kernel: tensors must be on a CUDA device, got {device}")
    if not 1 <= hidden <= MAX_HIDDEN:
        raise ValueError(f"{kernel} kernel: hidden count {hidden} not in [1, {MAX_HIDDEN}] (the kernels' limit)")
    for name, (t, dtype, shape) in tensors.items():
        if t.device != device or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{kernel} kernel: {name} must be a contiguous {dtype} tensor of shape {shape} on {device}; "
                f"got {t.dtype} {tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})"
            )


def check_launch(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C launch function."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")
