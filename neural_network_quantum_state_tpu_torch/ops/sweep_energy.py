"""Fused sweeps + off-diagonal local-energy sum: CUDA megakernel and plain
version.

``sweeps_offdiag`` runs the proposal rounds of ``ops.sweep.metropolis_sweeps``
(n_beta >= 1, with the swap phases after each sweep) and then the
off-diagonal sum of ``ops.energy.offdiag_sum`` on the post-sweep state of
every walker row, tempered replicas included. A CUDA tensor goes to the
kernel in ``csrc/sweep_energy.cu`` (float32), one launch in which the state
never leaves the chip between the two phases; it reads one table for both,
``engine.sweep_table_f32``'s e^{4 s w} and per-site factors, and refuses
weights with |Re w| above ``engine.F32_MAX_RE_W`` before any launch. A CPU
tensor goes to ``sweeps_offdiag_plain``, the plain sweep followed by the
plain sum on the same uniforms. As in the JAX package, both cover the RBM
family only (c = 1) and refuse output weights c.

Replaces ``neural_network_quantum_state_tpu/ops/pallas_sweep_energy.py``
(``pallas_sweeps_offdiag``).
"""

from __future__ import annotations

import torch

from neural_network_quantum_state_tpu_torch.ops import engine
from neural_network_quantum_state_tpu_torch.ops.energy import offdiag_sum_plain
from neural_network_quantum_state_tpu_torch.ops.engine import Cache, Work
from neural_network_quantum_state_tpu_torch.ops.sweep import launch_sweeps, sweep_plain


def _check_rbm_family(work: Work) -> None:
    if work.c is not None:
        raise ValueError("sweep_energy: the megakernel covers the RBM family only (c = 1); "
                         "this machine has output weights c (the FFNN family)")


def sweeps_offdiag_plain(work: Work, cache: Cache, lnpsi: torch.Tensor, schedule, uniforms,
                         n_beta: int = 1, swap_uniforms: torch.Tensor | None = None):
    """The plain sweep, then the plain sum; returns (cache, lnpsi,
    n_accepted, offdiag (K,) complex)."""
    _check_rbm_family(work)
    sweeps_offdiag_plain.calls += 1
    cache, lnpsi, n_acc = sweep_plain(work, cache, lnpsi, schedule, uniforms, n_beta, swap_uniforms)
    return cache, lnpsi, n_acc, offdiag_sum_plain(work, cache, lnpsi)


sweeps_offdiag_plain.calls = 0


def sweeps_offdiag_cuda(work: Work, cache: Cache, schedule, uniforms, n_beta: int = 1,
                        swap_uniforms: torch.Tensor | None = None):
    """Launch the megakernel; returns (cache, lnpsi, n_accepted, offdiag
    (K,) complex64). Its table (and the range check before it) comes from
    ``engine.sweep_table_f32``, once per weight tensor. ln psi of the final
    states is recomputed with the plain log-cosh, as ``ops.sweep.sweep_cuda``
    does."""
    _check_rbm_family(work)
    out = torch.empty(cache.spins.shape[0], dtype=torch.complex64, device=cache.spins.device)
    cache, stats = launch_sweeps("sweep_energy", work, cache, schedule, uniforms, n_beta, swap_uniforms, (out,))
    sweeps_offdiag_cuda.launches += 1
    lnpsi = engine.cache_log_psi(work, cache)
    return cache, lnpsi, stats[0].sum(dtype=torch.float64), out


sweeps_offdiag_cuda.launches = 0


def sweeps_offdiag(work: Work, cache: Cache, lnpsi: torch.Tensor, schedule, uniforms,
                   n_beta: int = 1, swap_uniforms: torch.Tensor | None = None):
    """uniforms.shape[0] proposal rounds, then sum_i exp(ln psi(flip_i s')
    - ln psi(s')) on the new states s'; returns (cache, lnpsi, n_accepted,
    offdiag).

    The kernel on a CUDA tensor (or an error), the plain version on a CPU one.
    """
    if cache.spins.device.type == "cpu":
        return sweeps_offdiag_plain(work, cache, lnpsi, schedule, uniforms, n_beta, swap_uniforms)
    return sweeps_offdiag_cuda(work, cache, schedule, uniforms, n_beta, swap_uniforms)
