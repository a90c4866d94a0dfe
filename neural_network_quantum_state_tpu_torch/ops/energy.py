"""Off-diagonal local-energy sum: CUDA kernel and plain version.

``offdiag_sum`` returns, per walker, the complex
``sum_i exp(ln psi(flip_i s) - ln psi(s))`` over all N sites. A CUDA tensor
goes to the kernel in ``csrc/energy.cu``: its float32 instances (one for the
RBM family, c = 1, and one for the FFNN family's complex output weights),
or for float64 tensors (``energy_dtype=torch.float64``) its float64
instance, which the JAX package sends to XLA (its Pallas kernel is float32
only); any other dtype raises. The float32 instances read the weights
through the table ``engine.kernel_table``, the float64 instance through
``engine.kernel_table_f64`` (e^{4 s w} and the per-site sums of w, in two
parts). A CPU tensor goes to ``offdiag_sum_plain``, the chunked PyTorch
computation, in any dtype.

Replaces ``neural_network_quantum_state_tpu/ops/pallas_energy.py``.
"""

from __future__ import annotations

import ctypes

import torch

from neural_network_quantum_state_tpu_torch.ops import build, engine
from neural_network_quantum_state_tpu_torch.ops.engine import Cache, Work
from neural_network_quantum_state_tpu_torch.ops.logcosh import near_branch_cut

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


def offdiag_near_cut(work: Work, cache: Cache) -> torch.Tensor:
    """(K,) bool: the walkers whose y, or y after any single flip, has a
    hidden unit near the principal log-cosh's branch cut
    (``logcosh.near_branch_cut``). With output weights c the kernel and the
    plain sum of such a walker may differ by the jump, so comparisons count
    them apart."""
    k, n = cache.spins.shape
    chunk = max(1, min(n, OFFDIAG_CHUNK_ELEMS // max(1, k * work.w.shape[1])))
    out = near_branch_cut(cache.y)
    for start in range(0, n, chunk):
        sites = torch.arange(start, min(n, start + chunk), device=cache.y.device)
        y1 = cache.y[:, None, :] - 2.0 * cache.spins[:, sites, None] * work.w[sites][None]
        out |= near_branch_cut(y1).any(-1)
    return out


# The kernel's instances by the spins' dtype: (C symbol, complex dtype).
INSTANCES = {torch.float32: ("nqs_offdiag_f32", torch.complex64), torch.float64: ("nqs_offdiag_f64_tiled", torch.complex128)}


def _kernel(symbol: str):
    """The C launch function: six pointers, three ints, the stream, and for
    the float64 instance the low part of its per-site term."""
    fn = getattr(build.library("energy"), symbol)
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * (1 + (symbol != "nqs_offdiag_f32"))
    fn.restype = ctypes.c_int
    return fn


def offdiag_sum_cuda(work: Work, cache: Cache) -> torch.Tensor:
    """Launch the energy kernel's instance for the cache's dtype: float32
    (``launches``) or float64 (``launches_f64``, of which those with output
    weights c also in ``launches_f64_c``); returns (K,) complex of that
    precision. ln psi(s) is recomputed in the kernel from y, so no ln
    psi argument is taken. Any other dtype raises, and so do float64 weights
    past the float64 kernels' range (``engine.check_f64_range``)."""
    k, n = cache.spins.shape
    h = work.w.shape[1]
    dev = cache.spins.device
    if cache.spins.dtype not in INSTANCES:
        raise NotImplementedError(f"energy kernel: float32 and float64 are ported, got {cache.spins.dtype}")
    symbol, cdt = INSTANCES[cache.spins.dtype]
    tensors, weights = engine.kernel_weights(work, cdt)
    build.check_inputs("energy", dev, h, tensors | {
        "spins": (cache.spins, cache.spins.dtype, (k, n)),
        "y": (cache.y, cdt, (k, h)),
    })
    if cache.spins.dtype == torch.float32:
        ptrs = (engine.kernel_table(work.w).data_ptr(), *weights[1:])
    else:  # its own table, and a shifted by the per-site sums of w in two parts, inside its range
        engine.check_f64_range(work.w, "energy kernel, float64")
        table, a_site, a_lo = engine.kernel_table_f64(work)
        ptrs = (table.data_ptr(), a_site.data_ptr(), weights[2])
    out = torch.empty(k, dtype=cdt, device=dev)
    rc = build.launch(
        dev, _kernel(symbol), *ptrs, cache.spins.data_ptr(), cache.y.data_ptr(), out.data_ptr(), k, n, h,
        torch.cuda.current_stream(dev).cuda_stream, *(() if cache.spins.dtype == torch.float32 else (a_lo.data_ptr(),)),
    )
    build.check_launch(rc, f"energy kernel ({symbol})")
    if cache.spins.dtype == torch.float32:
        offdiag_sum_cuda.launches += 1
    else:
        offdiag_sum_cuda.launches_f64 += 1
        offdiag_sum_cuda.launches_f64_c += int(work.c is not None)
    return out


offdiag_sum_cuda.launches = 0
offdiag_sum_cuda.launches_f64 = 0
offdiag_sum_cuda.launches_f64_c = 0


def offdiag_sum(work: Work, cache: Cache, lnpsi: torch.Tensor) -> torch.Tensor:
    """sum_i exp(ln psi(flip_i s) - ln psi(s)) -> (K,) complex.

    The kernel on a CUDA tensor (or an error), the plain version on a CPU one.
    """
    if cache.spins.device.type == "cpu":
        return offdiag_sum_plain(work, cache, lnpsi)
    return offdiag_sum_cuda(work, cache)
