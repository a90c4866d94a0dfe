"""Off-diagonal local-energy sum: CUDA kernel and plain version.

``offdiag_sum`` returns, per walker, the complex
``sum_i exp(ln psi(flip_i s) - ln psi(s))`` over all N sites. A CUDA tensor
goes to the kernel in ``csrc/energy.cu`` (float32, RBM family); a CPU tensor
goes to ``offdiag_sum_plain``, the chunked PyTorch computation.

Replaces ``neural_network_quantum_state_tpu/ops/pallas_energy.py``.
"""

from __future__ import annotations

import ctypes

import torch

from neural_network_quantum_state_tpu_torch.ops import build, engine
from neural_network_quantum_state_tpu_torch.ops.engine import Cache, Work

OFFDIAG_CHUNK_ELEMS = 64 * 1024 * 1024  # cap K*chunk*H per flip tensor


def offdiag_sum_plain(work: Work, cache: Cache, lnpsi: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch sum over site chunks sized to ~64M flip elements."""
    offdiag_sum_plain.calls += 1
    k, n = cache.spins.shape
    h = work.w.shape[1]
    chunk = max(1, min(n, OFFDIAG_CHUNK_ELEMS // max(1, k * h)))
    total = torch.zeros(k, dtype=lnpsi.dtype, device=lnpsi.device)
    for start in range(0, n, chunk):
        sites = torch.arange(start, min(n, start + chunk), device=lnpsi.device)
        lnpsi1 = engine.all_flip_log_psi(work, cache, sites)  # (K, chunk)
        total = total + torch.exp(lnpsi1 - lnpsi[:, None]).sum(-1)
    return total


offdiag_sum_plain.calls = 0


def _kernel():
    fn = build.library("energy").nqs_offdiag_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def offdiag_sum_cuda(work: Work, cache: Cache) -> torch.Tensor:
    """Launch the energy kernel; returns (K,) complex64. ln psi(s) is
    recomputed in the kernel from y, so no ln psi argument is taken."""
    k, n = cache.spins.shape
    h = work.w.shape[1]
    dev = cache.spins.device
    if cache.spins.dtype != torch.float32:
        raise NotImplementedError(f"energy kernel: only float32 is ported, got {cache.spins.dtype}")
    if work.a is None:
        raise ValueError("energy kernel: the RBM family has a visible bias (work.a is None)")
    build.check_inputs("energy", dev, h, {
        "w": (work.w, torch.complex64, (n, h)),
        "a": (work.a, torch.complex64, (n,)),
        "spins": (cache.spins, torch.float32, (k, n)),
        "y": (cache.y, torch.complex64, (k, h)),
    })
    out = torch.empty(k, dtype=torch.complex64, device=dev)
    rc = _kernel()(
        work.w.data_ptr(), work.a.data_ptr(), cache.spins.data_ptr(), cache.y.data_ptr(),
        out.data_ptr(), k, n, h, torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check_launch(rc, "energy kernel")
    offdiag_sum_cuda.launches += 1
    return out


offdiag_sum_cuda.launches = 0


def offdiag_sum(work: Work, cache: Cache, lnpsi: torch.Tensor) -> torch.Tensor:
    """sum_i exp(ln psi(flip_i s) - ln psi(s)) -> (K,) complex.

    The kernel on a CUDA tensor (or an error), the plain version on a CPU one.
    """
    if cache.spins.device.type == "cpu":
        return offdiag_sum_plain(work, cache, lnpsi)
    return offdiag_sum_cuda(work, cache)
