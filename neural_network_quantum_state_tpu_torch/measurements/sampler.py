"""Ansatz-only amplitude sampler for measurements (the JAX package's
``measurements/sampler.py``).

Equivalent of the reference's Sampler4SpinHalf (gpu/include/meas.cuh:11-28,
impl_meas.cuh:5-41): Markov chains driven purely by |psi|^2 of one machine
(no Hamiltonian), exposing exactly the primitives the measurement estimators
and the pynqs Python binding need - sample, read states, evaluate ln psi on
fixed spins (pywrapping_sampler.cu:20-132).

The estimator loop (``run_estimator``, ``run_pair_estimator``) replaces the
JAX package's one ``lax.scan``: each iteration is one sampler call (on the
card one launch of the sweep kernel, ``sampler/metropolis.py::sweeps``)
followed by the estimator's accumulation on the beta = 1 slice. The
per-iteration outputs stay on the device and are stacked there; each chunk
of iterations returns to the host in one copy, and nothing in the loop
waits for the device.

``mesh=`` shards the walkers over a walker mesh (``parallel/mesh.py``), as
the JAX package's sampler does: each sampler call runs once per shard (on
the card one launch per shard), a shard holds whole replica groups, and the
estimators read the walkers gathered in walker order onto the first shard's
device (``beta1``), where the parameters live. Two samplers on one mesh
share one sharding.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from neural_network_quantum_state_tpu_torch.models.base import Machine, Params
from neural_network_quantum_state_tpu_torch.ops import engine
from neural_network_quantum_state_tpu_torch.ops.engine import Cache
from neural_network_quantum_state_tpu_torch.ops.rng import make_generator, random_spins
from neural_network_quantum_state_tpu_torch.parallel.mesh import Mesh, gather, shard_walker_tree
from neural_network_quantum_state_tpu_torch.sampler import metropolis, tempering
from neural_network_quantum_state_tpu_torch.sampler.schedule import sequential


def check_shards(mesh: Mesh, n_walkers: int, n_beta: int) -> None:
    """Raise unless the walkers split over the mesh into shards of whole
    replica groups (the JAX package's error)."""
    if n_walkers % mesh.size != 0 or (n_walkers // mesh.size) % n_beta != 0:
        raise ValueError(
            f"walker shards must hold whole replica groups: k_total={n_walkers} "
            f"over {mesh.size} devices with n_beta={n_beta}"
        )


def generator_for(key: torch.Generator | int, device: torch.device) -> torch.Generator:
    """The sampler's generator: ``key`` itself, or one seeded with it on `device`."""
    if isinstance(key, torch.Generator):
        if key.device.type != device.type:
            raise ValueError(f"the generator is on {key.device}, the sampler on {device}")
        return key
    return make_generator(int(key), device)


def beta1(tree, n_beta: int):
    """beta = 1 replica slice of per-walker tensors (replica-minor), made
    contiguous (the kernels take contiguous tensors): a Cache, a tensor, or
    a tuple of them; sharded ones gathered in walker order first (a shard
    holds whole replica groups, so the slice is the same)."""
    tree = gather(tree)
    if n_beta == 1:
        return tree
    if isinstance(tree, torch.Tensor):
        return tree[::n_beta].contiguous()
    parts = (beta1(x, n_beta) for x in tree)
    return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)


def _to_host(outs: list) -> tuple[np.ndarray, ...]:
    """The per-iteration outputs of a chunk (a list of tuples of tensors),
    each position stacked on the device on a new axis 0, returned as float64
    numpy arrays through ONE device-to-host copy."""
    stacked = [torch.stack(col) for col in zip(*outs)]
    flat = torch.cat([s.reshape(-1).to(torch.float64) for s in stacked]).cpu().numpy()
    parts, off = [], 0
    for s in stacked:
        parts.append(flat[off : off + s.numel()].reshape(tuple(s.shape)))
        off += s.numel()
    return tuple(parts)


def run_chunked(step: Callable[[], tuple], n_iterations: int, chunk: int):
    """Call ``step`` (one iteration: advance, then accumulate; it returns a
    tensor or a tuple of tensors) ``n_iterations`` times and return its
    outputs stacked on axis 0 as numpy: one host copy per chunk of at most
    ``chunk`` iterations (one for all of them when ``chunk`` <= 0)."""
    sizes = [n_iterations]
    if 0 < chunk < n_iterations:
        n_full, rem = divmod(n_iterations, chunk)
        sizes = [chunk] * n_full + ([rem] if rem else [])
    single = False
    pieces = []
    for size in sizes:
        outs = []
        for _ in range(size):
            out = step()
            single = isinstance(out, torch.Tensor)
            outs.append((out,) if single else tuple(out))
        pieces.append(_to_host(outs))
    joined = tuple(np.concatenate(xs, axis=0) for xs in zip(*pieces))
    return joined[0] if single else joined


class AmplitudeSampler:
    """Stateful convenience wrapper (host-side) around the pure sampler.

    Sequential site sweep (the measurement-side order, impl_meas.cuh:5-41).
    """

    def __init__(
        self,
        machine: Machine,
        params: Params,
        n_walkers: int,
        key: torch.Generator | int = 0,
        init_spins: Optional[torch.Tensor] = None,
        schedule: Optional[np.ndarray] = None,
        n_beta: int = 1,
        mesh=None,
        use_fused: bool = False,
        device: torch.device | str = "cuda",
    ):
        """n_beta > 1 enables replica-exchange (parallel-tempered) sampling:
        n_walkers total chains hold n_walkers/n_beta physical chains x
        n_beta tempered replicas (replica-minor layout); ``spins``/``lnpsi``
        expose only the beta=1 slice. Use for near-critical/ordered states
        where plain Metropolis is metastable.

        ``key``: a seed or a ``torch.Generator`` on `device`; it draws the
        initial spins (unless ``init_spins`` is given) and then every sweep.
        ``use_fused`` is accepted as the JAX package's flag (a float32
        machine only); on the card every sampler call is one launch of the
        sweep kernel either way. ``mesh``: a walker mesh to shard the
        walkers over (its first device takes the place of ``device``)."""
        if n_beta > 1 and n_walkers % n_beta != 0:
            raise ValueError("n_walkers must be a multiple of n_beta")
        if use_fused and machine.dtype != torch.float32:
            raise ValueError("use_fused requires a float32 machine")
        if mesh is not None:
            check_shards(mesh, n_walkers, n_beta)
            device = mesh.devices[0]
        self.mesh = mesh
        self.device = torch.device(device)
        self.machine = machine
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.work = machine.make_work(self.params)
        self.n_beta = n_beta
        self.use_fused = use_fused
        g = generator_for(key, self.device)
        if init_spins is None:
            init_spins = random_spins(g, n_walkers, machine.n_inputs, machine.dtype)
        init_spins = torch.as_tensor(init_spins, dtype=machine.dtype, device=self.device)
        sched = schedule if schedule is not None else sequential(machine.n_inputs)
        self.schedule = torch.as_tensor(sched, dtype=torch.int32, device=self.device)
        self.state = metropolis.init_state(self.work, init_spins, g)
        if mesh is not None:
            self.state = shard_walker_tree(self.state, mesh, n_walkers)

    # -- reference API surface -------------------------------------------
    def warm_up(self, n_sweeps: int) -> None:
        self.do_mcmc_steps(n_sweeps)

    def _advance(self, state: metropolis.MCState, n_sweeps: int) -> metropolis.MCState:
        """state -> state advanced by n_sweeps: one sampler call (on the card
        one sweep-kernel launch, the ladder in the kernel for n_beta > 1)."""
        if self.n_beta > 1:
            return tempering.tempering_sweeps(self.work, state, self.schedule, n_sweeps, self.n_beta)
        return metropolis.sweeps(self.work, state, self.schedule, n_sweeps)

    def do_mcmc_steps(self, n_sweeps: int) -> None:
        self.state = self._advance(self.state, n_sweeps)

    def _beta1(self, tree):
        """beta=1 replica slice of a per-walker tensor tree (replica-minor)."""
        return beta1(tree, self.n_beta)

    # Per-call chunk bound used by run_estimator / run_pair_estimator when
    # the caller doesn't pass ``chunk`` explicitly; drivers.measure sets it
    # from -mchunk. 0 = one host copy for the whole run (the default).
    scan_chunk: int = 0

    def run_estimator(self, accum_fn, n_iterations: int, n_sweeps: int = 1, chunk: int | None = None):
        """Run ``n_iterations`` of (advance n_sweeps; accum_fn(cache, lnpsi))
        and return accum_fn's outputs stacked on axis 0, as host numpy
        (float64). ``accum_fn`` receives the beta=1 slice under tempering.

        Each iteration is one sampler call; the outputs stay on the device
        until a chunk of ``chunk`` iterations (all of them for ``chunk`` <= 0;
        ``None`` falls back to ``self.scan_chunk``) is copied back at once.
        A chunked run and an unchunked one from the same state give the same
        outputs."""
        chunk = self.scan_chunk if chunk is None else chunk

        def step():
            self.state = self._advance(self.state, n_sweeps)
            return accum_fn(self._beta1(self.state.cache), self._beta1(self.state.lnpsi))

        return run_chunked(step, n_iterations, chunk)

    @property
    def spins(self) -> torch.Tensor:
        """Current spin states (K, N) - get_quantumStates(). With tempering,
        only the beta=1 replicas (impl_mcmc_sampler.hpp:193-205)."""
        return gather(self.state.cache.spins)[:: self.n_beta]

    @property
    def lnpsi(self) -> torch.Tensor:
        """ln psi of the current states (K,) complex - get_lnpsi(); beta=1 slice."""
        return gather(self.state.lnpsi)[:: self.n_beta]

    def log_psi(self, spins: torch.Tensor) -> torch.Tensor:
        """ln psi on fixed spin configurations - get_lnpsi_for_fixed_spins()."""
        return engine.log_psi(self.work, torch.as_tensor(spins, dtype=self.machine.dtype, device=self.device))

    @property
    def n_walkers(self) -> int:
        """Effective estimator walkers (beta=1 replicas under tempering)."""
        return int(self.state.cache.spins.shape[0]) // self.n_beta

    @property
    def n_inputs(self) -> int:
        return self.machine.n_inputs


def run_pair_estimator(
    s1: AmplitudeSampler,
    s2: AmplitudeSampler,
    accum_fn: Callable[[Cache, torch.Tensor, Cache, torch.Tensor], tuple],
    n_iterations: int,
    n_sweeps: int = 1,
    chunk: int | None = None,
):
    """Two-replica variant of :meth:`AmplitudeSampler.run_estimator`: both
    samplers advance in lock-step (the Renyi/fidelity pattern,
    impl_meas.cuh:57-99), one sampler call each per iteration.
    ``accum_fn(c1, ln1, c2, ln2)`` sees the beta=1 slices. ``chunk`` bounds
    the iterations per host copy exactly like
    :meth:`AmplitudeSampler.run_estimator`; ``None`` falls back to the
    larger of the two samplers' ``scan_chunk``."""
    if chunk is None:
        chunk = max(s1.scan_chunk, s2.scan_chunk)

    def step():
        s1.state = s1._advance(s1.state, n_sweeps)
        s2.state = s2._advance(s2.state, n_sweeps)
        return accum_fn(s1._beta1(s1.state.cache), s1._beta1(s1.state.lnpsi),
                        s2._beta1(s2.state.cache), s2._beta1(s2.state.lnpsi))

    return run_chunked(step, n_iterations, chunk)
