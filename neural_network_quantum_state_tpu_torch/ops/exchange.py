"""Kawasaki pair-exchange proposals: CUDA kernel and plain version.

``exchange_steps`` runs ``n_steps = u_sel.shape[0]`` proposal rounds. In
round t every walker masks its active (anti-aligned) bonds, picks the
(target+1)-th of its nb active bonds in bond order with
``target = min(floor(u_sel[t] * nb), max(nb - 1, 0))``, flips both ends and
accepts where ``u_acc[t] < exp(2 min(Re dln, 0))`` and nb > 0. A CUDA
tensor goes to the kernel in ``csrc/exchange.cu`` (float32; an instance for
the RBM family, c = 1, and one for the FFNN family's complex output
weights); a CPU tensor goes to ``exchange_plain``, the same computation in
PyTorch.
Both take the same caller-drawn uniforms, so they make the same decisions.

Replaces ``neural_network_quantum_state_tpu/ops/pallas_exchange.py``.
"""

from __future__ import annotations

import ctypes

import torch

from neural_network_quantum_state_tpu_torch.ops import build, engine
from neural_network_quantum_state_tpu_torch.ops.engine import Cache, Work


def select_active_bond(active: torch.Tensor, u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Uniformly pick one active bond per walker.

    active: (K, B) bool; u: (K,) uniforms. Returns (bond (K,), nb (K,)):
    the index of the (target+1)-th active bond by the running-sum inverse
    CDF, and the number of active bonds. A walker with none gets bond B-1.
    """
    nb = active.sum(1)
    target = torch.floor(u * nb).to(nb.dtype)  # u * nb in u's float dtype
    target = torch.minimum(target, (nb - 1).clamp(min=0))
    cs = torch.cumsum(active.to(torch.int32), 1)
    bond = (cs <= target[:, None]).sum(1)
    return bond.clamp(max=active.shape[1] - 1), nb


def exchange_plain(work: Work, cache: Cache, lnpsi: torch.Tensor, bonds: torch.Tensor, u_sel: torch.Tensor, u_acc: torch.Tensor):
    """Plain PyTorch proposal rounds; returns (cache, lnpsi, n_accepted)."""
    exchange_plain.calls += 1
    bonds = bonds.to(device=cache.spins.device, dtype=torch.long)
    n_acc = torch.zeros((), dtype=torch.float64, device=u_acc.device)
    for t in range(u_sel.shape[0]):
        s = cache.spins
        active = s[:, bonds[:, 0]] * s[:, bonds[:, 1]] < 0
        bond, nb = select_active_bond(active, u_sel[t])
        i, j = bonds[bond, 0], bonds[bond, 1]
        lnpsi1 = engine.flip2_log_psi_per_walker(work, cache, i, j)
        dln = lnpsi1.real - lnpsi.real
        accept = (u_acc[t] < torch.exp(2.0 * torch.clamp(dln, max=0.0))) & (nb > 0)
        cache = engine.commit_flip2_per_walker(work, cache, i, j, accept)
        lnpsi = torch.where(accept, lnpsi1, lnpsi)
        n_acc = n_acc + accept.sum()
    return cache, lnpsi, n_acc


exchange_plain.calls = 0


def _kernel():
    fn = build.library("exchange").nqs_exchange_f32
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def exchange_cuda(work: Work, cache: Cache, bonds: torch.Tensor, u_sel: torch.Tensor, u_acc: torch.Tensor):
    """Launch the exchange kernel; returns (cache, lnpsi, n_accepted).

    `bonds` is a contiguous (B, 2) int32 tensor on the walkers' device with
    1 <= B <= N and entries in [0, N) (the kernel traps on an entry out of
    range). The complex ln psi of the final states is recomputed from the
    final cache with the plain log-cosh, as in ``ops.sweep.sweep_cuda``.
    """
    k, n = cache.spins.shape
    h = work.w.shape[1]
    dev = cache.spins.device
    if cache.spins.dtype != torch.float32:
        raise NotImplementedError(f"exchange kernel: only float32 is ported, got {cache.spins.dtype}")
    b, n_steps = bonds.shape[0], u_sel.shape[0]
    if not 1 <= b <= n:
        raise ValueError(f"exchange kernel: bond count {b} not in [1, N={n}]")
    tensors, weights = engine.kernel_weights(work)
    build.check_inputs("exchange", dev, h, tensors | {
        "bonds": (bonds, torch.int32, (b, 2)),
        "spins": (cache.spins, torch.float32, (k, n)),
        "y": (cache.y, torch.complex64, (k, h)),
        "sa": (cache.sa, torch.complex64, (k,)),
        "u_sel": (u_sel, torch.float32, (n_steps, k)),
        "u_acc": (u_acc, torch.float32, (n_steps, k)),
    })
    if n_steps == 0:
        raise ValueError("exchange kernel: no proposal rounds (u_sel has 0 rows)")
    spins = torch.empty_like(cache.spins)
    y = torch.empty_like(cache.y)
    sa = torch.empty_like(cache.sa)
    acc = torch.empty(k, dtype=torch.int32, device=dev)
    rc = _kernel()(
        *weights, bonds.data_ptr(), cache.spins.data_ptr(), cache.y.data_ptr(),
        cache.sa.data_ptr(), u_sel.data_ptr(), u_acc.data_ptr(), spins.data_ptr(), y.data_ptr(),
        sa.data_ptr(), acc.data_ptr(), k, n, h, b, n_steps, torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check_launch(rc, "exchange kernel")
    exchange_cuda.launches += 1
    cache = Cache(spins=spins, y=y, sa=sa)
    return cache, engine.cache_log_psi(work, cache), acc.sum(dtype=torch.float64)


exchange_cuda.launches = 0


def exchange_steps(work: Work, cache: Cache, lnpsi: torch.Tensor, bonds: torch.Tensor, u_sel: torch.Tensor, u_acc: torch.Tensor):
    """Run u_sel.shape[0] pair-exchange rounds; returns (cache, lnpsi, n_accepted).

    The kernel on a CUDA tensor (or an error), the plain version on a CPU one.
    """
    if cache.spins.device.type == "cpu":
        return exchange_plain(work, cache, lnpsi, bonds, u_sel, u_acc)
    return exchange_cuda(work, cache, bonds, u_sel, u_acc)
