"""Fermion measurements: particle-conserving sampler + pair OPDM (the JAX
package's ``measurements/fermion.py``).

Reference: fermion::jordanwigner::Sampler4SpinHalf and MeasOPDM
(gpu/include/meas.cuh:226-283, impl_meas.cuh:505-688). The estimator is the
pair one-particle density matrix

    OPDM(n,m) = <psi| c+_{n+m,up} c+_{n+m,dn} c_{n,dn} c_{n,up} |psi>

with JW-string local value (meas__OPDM__ kernels, impl_meas.cuh:648-686):

    m>0: 1/16 (1+s^up_{n+m})(1+s^dn_{n+m})(1-s^up_n)(1-s^dn_n)
              * prod_{l=n+1}^{n+m-1} s^up_l s^dn_l * psi(flip)/psi(s)
    m=0: 1/4 (1+s^up_n)(1+s^dn_n)          (double occupancy)

where flip negates sites n and n+m in both flavor sectors. Each estimator
iteration is one sampler call: on the card one launch of the exchange
kernel (its tempered instance for n_beta > 1), once per shard of a walker
mesh (``mesh=``, as ``AmplitudeSampler``'s): the shards conserve every
walker's sector as one device does.
"""

from __future__ import annotations

import numpy as np
import torch

from neural_network_quantum_state_tpu_torch.hamiltonians.hubbard import HubbardChain
from neural_network_quantum_state_tpu_torch.measurements.sampler import (
    beta1,
    check_shards,
    generator_for,
    run_chunked,
)
from neural_network_quantum_state_tpu_torch.models.base import Machine, Params
from neural_network_quantum_state_tpu_torch.ops import engine
from neural_network_quantum_state_tpu_torch.parallel.mesh import gather, shard_walker_tree
from neural_network_quantum_state_tpu_torch.sampler import kawasaki, metropolis


class FermionAmplitudeSampler:
    """|psi|^2 sampler with Kawasaki pair-exchange proposals (conserves
    per-flavor particle numbers) - fermion Sampler4SpinHalf."""

    def __init__(
        self,
        machine: Machine,
        params: Params,
        n_walkers: int,
        n_up: int,
        n_down: int,
        key: torch.Generator | int = 0,
        per_flavor_rings: bool = True,
        mesh=None,
        use_fused: bool = False,
        n_beta: int = 1,
        device: torch.device | str = "cuda",
    ):
        """n_beta > 1 enables replica-exchange (parallel-tempered) exchange
        sampling (kawasaki.tempered_exchange_sweeps): n_walkers total chains
        = n_walkers/n_beta physical chains x n_beta tempered replicas,
        replica-minor; ``spins``/``lnpsi``/estimators expose the beta=1
        slice. Sector-preserving by construction (swaps exchange whole
        in-sector configurations). As in the JAX package it does not combine
        with ``use_fused``, which is accepted (a float32 machine only) and
        changes no route: on the card every sampler call is one launch of
        the exchange kernel. ``mesh``: a walker mesh to shard the walkers
        over (its first device takes the place of ``device``)."""
        if machine.n_inputs % 2 != 0:
            raise ValueError("fermion machines need 2L inputs")
        if n_beta > 1 and n_walkers % n_beta != 0:
            raise ValueError("n_walkers must be a multiple of n_beta")
        if n_beta > 1 and use_fused:
            raise ValueError("use_fused does not implement tempered exchange (set n_beta=1)")
        if use_fused and machine.dtype != torch.float32:
            raise ValueError("use_fused requires a float32 machine")
        if mesh is not None:
            check_shards(mesh, n_walkers, n_beta)
            device = mesh.devices[0]
        self.mesh = mesh
        self.device = torch.device(device)
        self.n_beta = n_beta
        self.machine = machine
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.work = machine.make_work(self.params)
        self.l = machine.n_inputs // 2
        self.use_fused = use_fused
        g = generator_for(key, self.device)
        ham = HubbardChain(n_sites=machine.n_inputs, n_up=n_up, n_down=n_down)
        spins = ham.init_spins(g, n_walkers, machine.dtype)
        bonds = kawasaki.two_ring_bonds(self.l) if per_flavor_rings else kawasaki.ring_bonds(machine.n_inputs)
        self.bonds = torch.as_tensor(bonds, dtype=torch.int32, device=self.device)
        self.n_unit_steps = machine.n_inputs
        self.state = metropolis.init_state(self.work, spins, g)
        if mesh is not None:
            self.state = shard_walker_tree(self.state, mesh, n_walkers)

    def _advance(self, state: metropolis.MCState, n_sweeps: int) -> metropolis.MCState:
        """One sampler call (on the card one exchange-kernel launch; none for
        n_sweeps <= 0)."""
        return kawasaki.tempered_exchange_sweeps(self.work, state, self.bonds, n_sweeps, self.n_unit_steps,
                                                 self.n_beta)

    def warm_up(self, n_sweeps: int) -> None:
        self.do_mcmc_steps(n_sweeps)

    def do_mcmc_steps(self, n_sweeps: int) -> None:
        self.state = self._advance(self.state, n_sweeps)

    # Per-call chunk bound, as in AmplitudeSampler.scan_chunk. 0 = one host
    # copy for the whole run.
    scan_chunk: int = 0

    def run_estimator(self, accum_fn, n_iterations: int, n_sweeps: int = 1, chunk: int | None = None):
        """Run ``n_iterations`` of (advance n_sweeps; accum_fn(cache, lnpsi)),
        like :meth:`AmplitudeSampler.run_estimator`: one sampler call per
        iteration, the outputs copied back once per chunk of ``chunk``
        iterations (``None`` falls back to ``self.scan_chunk``)."""
        chunk = self.scan_chunk if chunk is None else chunk

        def step():
            self.state = self._advance(self.state, n_sweeps)
            return accum_fn(self._beta1(self.state.cache), self._beta1(self.state.lnpsi))

        return run_chunked(step, n_iterations, chunk)

    def _beta1(self, tree):
        """beta=1 replica slice of a per-walker tensor tree (replica-minor)."""
        return beta1(tree, self.n_beta)

    @property
    def spins(self) -> torch.Tensor:
        return gather(self.state.cache.spins)[:: self.n_beta]

    @property
    def lnpsi(self) -> torch.Tensor:
        return gather(self.state.lnpsi)[:: self.n_beta]


def opdm_pair(
    sampler: FermionAmplitudeSampler,
    n: int,
    m: int,
    n_iterations: int,
    n_sweeps: int = 1,
    n_warmup: int = 100,
) -> complex:
    """<c+_{n+m,up} c+_{n+m,dn} c_{n,dn} c_{n,up}> (MeasOPDM::measure,
    impl_meas.cuh:592-645)."""
    l = sampler.l
    if not (0 <= n and n + m < l and m >= 0):
        raise ValueError("(n+m) must be < L and n, m >= 0")
    work = sampler.work
    sampler.warm_up(n_warmup)
    flip = torch.as_tensor([n, n + m, l + n, l + n + m], device=sampler.device)

    def local(cache, lnpsi):
        s = cache.spins
        if m == 0:
            val = 0.25 * (1.0 + s[:, n]) * (1.0 + s[:, l + n])
            return val.mean(), torch.zeros((), dtype=s.dtype, device=s.device)
        flipped = s.clone()
        flipped[:, flip] = -s[:, flip]
        ratio = torch.exp(engine.log_psi(work, flipped) - lnpsi)
        string = torch.prod(s[:, n + 1 : n + m] * s[:, l + n + 1 : l + n + m], dim=1)
        coeff = (
            (1.0 / 16.0)
            * (1.0 + s[:, n + m])
            * (1.0 + s[:, l + n + m])
            * (1.0 - s[:, n])
            * (1.0 - s[:, l + n])
            * string
        )
        return (coeff * ratio.real).mean(), (coeff * ratio.imag).mean()

    re, im = sampler.run_estimator(local, n_iterations, n_sweeps)
    return complex(np.mean(re), np.mean(im))


def density_profile(
    sampler: FermionAmplitudeSampler,
    n_iterations: int,
    n_sweeps: int = 1,
    n_warmup: int = 100,
) -> np.ndarray:
    """Per-site mean occupations <n_i> for both flavors -> (2L,) array
    (the m = 0 OPDM diagonal measured for every site in ONE estimator run:
    n_i = (1 + s_i)/2 under the JW convention, diagonal in the s basis so
    no forwards are needed). The trap-profile observable of the reference's
    trapped-Hubbard study (fermi_hubbard_CH-train_rbm.cu:117-128)."""
    sampler.warm_up(n_warmup)

    def local(cache, lnpsi):
        return (0.5 * (1.0 + cache.spins)).mean(0)  # (2L,)

    occ = sampler.run_estimator(local, n_iterations, n_sweeps)  # (iters, 2L)
    return np.asarray(np.mean(occ, axis=0))
