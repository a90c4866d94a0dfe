"""Fused single-flip Metropolis sweeps: CUDA kernel and plain version.

``metropolis_sweeps`` runs ``n_steps = uniforms.shape[0]`` proposal rounds,
round t flipping site ``schedule[t % n_sites]`` in every walker and
accepting where ``uniforms[t] < exp(2 min(Re dln, 0))``. A CUDA tensor goes
to the kernel in ``csrc/sweep.cu`` (float32, RBM family); a CPU tensor goes
to ``sweep_plain``, the same computation in PyTorch. Both take the same
caller-drawn uniforms, so they make the same decisions.

Replaces ``neural_network_quantum_state_tpu/ops/pallas_sweep.py`` (n_beta = 1).
"""

from __future__ import annotations

import ctypes

import torch

from neural_network_quantum_state_tpu_torch.ops import build, engine
from neural_network_quantum_state_tpu_torch.ops.engine import Cache, Work
from neural_network_quantum_state_tpu_torch.ops.logcosh import logcosh


def sweep_plain(work: Work, cache: Cache, lnpsi: torch.Tensor, schedule, uniforms: torch.Tensor):
    """Plain PyTorch sweeps; returns (cache, lnpsi, n_accepted)."""
    sweep_plain.calls += 1
    sites = [int(s) for s in torch.as_tensor(schedule).tolist()]
    n_acc = torch.zeros((), dtype=torch.float64, device=uniforms.device)
    for t in range(uniforms.shape[0]):
        site = sites[t % len(sites)]
        lnpsi1 = engine.flip_log_psi(work, cache, site)
        dln = lnpsi1.real - lnpsi.real
        accept = uniforms[t] < torch.exp(2.0 * torch.clamp(dln, max=0.0))
        cache = engine.commit_flip(work, cache, site, accept)
        lnpsi = torch.where(accept, lnpsi1, lnpsi)
        n_acc = n_acc + accept.sum()
    return cache, lnpsi, n_acc


sweep_plain.calls = 0


def _kernel():
    fn = build.library("sweep").nqs_sweep_f32
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sweep_cuda(work: Work, cache: Cache, schedule, uniforms: torch.Tensor):
    """Launch the sweep kernel; returns (cache, lnpsi, n_accepted).

    The complex ln psi of the final states is recomputed from the final
    cache with the plain log-cosh, as every later consumer mixes it with
    ln psi values computed by that log-cosh.
    """
    k, n = cache.spins.shape
    h = work.w.shape[1]
    dev = cache.spins.device
    if cache.spins.dtype != torch.float32:
        raise NotImplementedError(f"sweep kernel: only float32 is ported, got {cache.spins.dtype}")
    if work.a is None:
        raise ValueError("sweep kernel: the RBM family has a visible bias (work.a is None)")
    sched = torch.as_tensor(schedule, dtype=torch.int32, device=dev)
    n_steps = uniforms.shape[0]
    build.check_inputs("sweep", dev, h, {
        "w": (work.w, torch.complex64, (n, h)),
        "a": (work.a, torch.complex64, (n,)),
        "spins": (cache.spins, torch.float32, (k, n)),
        "y": (cache.y, torch.complex64, (k, h)),
        "sa": (cache.sa, torch.complex64, (k,)),
        "uniforms": (uniforms, torch.float32, (n_steps, k)),
    })
    if n_steps == 0:
        raise ValueError("sweep kernel: no proposal rounds (uniforms has 0 rows)")
    spins = torch.empty_like(cache.spins)
    y = torch.empty_like(cache.y)
    sa = torch.empty_like(cache.sa)
    acc = torch.empty(k, dtype=torch.int32, device=dev)
    rc = _kernel()(
        work.w.data_ptr(), work.a.data_ptr(), cache.spins.data_ptr(), cache.y.data_ptr(),
        cache.sa.data_ptr(), sched.data_ptr(), uniforms.data_ptr(), spins.data_ptr(),
        y.data_ptr(), sa.data_ptr(), acc.data_ptr(), k, n, h, sched.shape[0], n_steps,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check_launch(rc, "sweep kernel")
    sweep_cuda.launches += 1
    lnpsi = logcosh(y).sum(-1) + sa
    return Cache(spins=spins, y=y, sa=sa), lnpsi, acc.sum(dtype=torch.float64)


sweep_cuda.launches = 0


def metropolis_sweeps(work: Work, cache: Cache, lnpsi: torch.Tensor, schedule, uniforms: torch.Tensor):
    """Run uniforms.shape[0] proposal rounds; returns (cache, lnpsi, n_accepted).

    The kernel on a CUDA tensor (or an error), the plain version on a CPU one.
    """
    if cache.spins.device.type == "cpu":
        return sweep_plain(work, cache, lnpsi, schedule, uniforms)
    return sweep_cuda(work, cache, schedule, uniforms)
