"""High-level VMC ground-state optimization driver.

One SR iteration:

    sweeps  ->  local energy  ->  O_k  ->  SR solve  ->
    theta -= lr * dx    ->  recompute caches from the current spins

with the lambda schedule, the ||dx|| trust region, the NaN and
zero-variance guards and the RSD early stop. The iteration runs eagerly as
a Python loop. The sampler is chosen once, from the Hamiltonian's
``sampler_kind`` and ``n_beta``: single-site Metropolis sweeps over its
schedule, the same with replica exchange for n_beta > 1 (parallel
tempering; the estimators read the beta = 1 replicas ``[::n_beta]``), or
Kawasaki pair-exchange sweeps over its bonds (the Hubbard chain), tempered
the same way for n_beta > 1;
``block_moves_per_sweep`` appends symmetric block flips to the flip
samplers. On the card each sampler call (a warm-up, a step's sweeps) is
one launch of the sweep or the exchange kernel, and the spin chains'
off-diagonal local energy one launch of the energy kernel (its float32
instance, or its float64 one for ``energy_dtype=torch.float64`` and for a
float64 machine, whose sweeps and exchange run their float64 instances
too). On the CPU all of them run as plain PyTorch. A run whose walkers collapse escalates to tempering (tempered
exchange for an exchange Hamiltonian), or reseeds, as in the JAX package.

The solvers are the JAX package's: matrix-free CG (``cg``), the dense
``lu``/``cholesky``/``svd`` solves (with ``n_accumulations`` sampling
rounds), minSR, the diagonal ``sgd`` step, MINRES-QLP and ``auto`` (CG
with a MINRES-QLP fallback); ``precond_ema`` preconditions CG with a
moving average of diag(S). ``energy_dtype`` widens the estimators:
float64 recomputes ln psi, the local energy and O_k in float64;
"compensated" takes the float32 log-cosh differences and sums them in
float64 (ising family); no option is ignored.

``mesh`` (``parallel.make_mesh``, ``make_mesh_2d``, ``make_mesh_tp``) shards
the walkers over its devices, as the JAX package's ``mesh=`` does: the
parameters stay on the first shard's device (one generator there draws
every key), each shard holds whole replica groups, every sampler call and
local energy runs once per shard (on the card one kernel launch per shard),
and the SR sums over walkers are reduced over the shards (``optim/sr.py``).
The shards draw the unsharded run's random numbers, so a mesh run makes the
one-device run's decisions. As in JAX, n_walkers must be a multiple of the
mesh's devices times n_beta, and "compensated" is refused under a mesh.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Optional

import torch

from neural_network_quantum_state_tpu_torch.dtypes import complex_dtype
from neural_network_quantum_state_tpu_torch.hamiltonians.base import Hamiltonian
from neural_network_quantum_state_tpu_torch.models.base import Machine, Params
from neural_network_quantum_state_tpu_torch.ops import engine
from neural_network_quantum_state_tpu_torch.ops.engine import Cache
from neural_network_quantum_state_tpu_torch.ops.rng import make_generator
from neural_network_quantum_state_tpu_torch.ops.sweep import MAX_NBETA, replica_betas
from neural_network_quantum_state_tpu_torch.optim import solvers as dense_solvers
from neural_network_quantum_state_tpu_torch.optim.minres import sr_minres_solve
from neural_network_quantum_state_tpu_torch.optim.sr import (
    SRStats,
    energy_and_rsd,
    force_vector,
    lambda_schedule,
    sgd_diag_solve,
    sr_cg_solve,
    sr_dense_solve,
    sr_dense_solve_accumulated,
    sr_diag,
    sr_minsr_solve,
    walker_mean,
)
from neural_network_quantum_state_tpu_torch.parallel.mesh import (
    Mesh,
    gather,
    n_devices,
    replicate_tree,
    shard_map,
    shard_walker_tree,
)
from neural_network_quantum_state_tpu_torch.sampler import kawasaki, metropolis, tempering


@dataclasses.dataclass(frozen=True)
class VMCConfig:
    """Field for field the JAX package's VMCConfig, with the same defaults."""

    n_walkers: int = 1024
    n_sweeps_per_step: int = 1  # reference "nms"
    # dense solvers only: S and F averaged over this many sampling rounds per
    # iteration (reference "naccumulation")
    n_accumulations: int = 1
    learning_rate: float = 1e-2
    solver: str = "cg"  # cg | lu | cholesky | svd | sgd | minsr | auto | minresqlp
    cg_tol: float = 1e-5
    cg_max_iters: int = 1000
    rsd_cutoff: Optional[float] = None  # early stop
    n_beta: int = 1  # >1: parallel tempering (tempered exchange for the Hubbard chain; at most 16 on the card)
    # Trust region on ||S^-1 F||: near-singular solves on a collapsed walker
    # distribution emit huge steps that can pin the sampler. None disables.
    max_dx_norm: Optional[float] = 1.0
    # run() takes chunks of this many steps before it checks the NaN, RSD
    # and collapse stops and measures acceptance, as the JAX package does
    # (its chunk is one device call); the last partial chunk runs step by step.
    steps_per_host_loop: int = 1
    # Parity with the JAX package: requires a float32 machine. It selects no
    # sampler (the card always runs the sweep or the exchange kernel), but,
    # as in JAX, it chooses the collapse remediation of an exchange
    # Hamiltonian: True reseeds in the particle sector; False escalates to
    # tempered exchange. It refuses n_beta > 1 with an exchange Hamiltonian.
    use_fused_sweeps: bool = False
    # >0: this many symmetric block-flip proposals per sweep after the
    # sampler's sweeps (metropolis.block_flip_moves; flip Hamiltonians only)
    block_moves_per_sweep: int = 0
    # torch.float64: S/F reductions and the solve in f64. Defaulted to f64
    # for an f32 cg/auto solve at V >= LARGE_V_THRESHOLD (JAX's rule).
    solve_dtype: Optional[Any] = None
    # None, torch.float64 (widened forward, local energy and O_k in f64) or
    # "compensated" (f32 log-cosh differences summed in f64; ising family)
    energy_dtype: Optional[Any] = None
    # Collapse remediation: rsd pinned at zero for collapse_patience steps
    # escalates to parallel tempering with collapse_escalate_nbeta replicas
    # (0: tuned from measured swap acceptance) or, where no ladder applies
    # (1 or < 0, a walker count no ladder divides, already tempered),
    # reseeds a fraction of the walkers.
    auto_remediate: bool = True
    collapse_patience: int = 3
    collapse_escalate_nbeta: int = 4
    collapse_reseed_frac: float = 0.5
    collapse_requil_sweeps: int = 100
    # >0: precondition CG with an exponential moving average of diag(S)
    # (this decay per iteration); regularization still uses the current
    # diag(S). cg/auto solvers only.
    precond_ema: float = 0.0
    seed: int = 0


# Large-V mixed-precision policy (the JAX package's vmc.py): a pure-f32 CG
# solve at V >~ 500 stagnates on roundoff; f64 is cheap.
LARGE_V_THRESHOLD = 500
LARGE_V_SOLVERS = ("cg", "auto")
SOLVER_NAMES = ("cg", "lu", "cholesky", "svd", "sgd", "minsr", "auto", "minresqlp")
_NBETA_CANDIDATES = (2, 4, 6, 8, 12, 16)  # all within the kernel's MAX_NBETA
# Below any honest Monte-Carlo relative standard deviation: rsd this small
# only happens when every walker is pinned on one configuration.
_COLLAPSE_RSD = 1e-12


def wants_large_v_mixed_precision(machine: Machine, solver: str) -> bool:
    """True where the JAX package defaults solve_dtype to float64: a float32
    machine with V >= LARGE_V_THRESHOLD and a cg or auto solve."""
    return machine.n_vars >= LARGE_V_THRESHOLD and solver in LARGE_V_SOLVERS and machine.dtype == torch.float32


def _bits(dtype: torch.dtype) -> int:
    return torch.finfo(dtype).bits


class VMC:
    def __init__(
        self,
        machine: Machine,
        hamiltonian: Hamiltonian,
        config: VMCConfig = VMCConfig(),
        mesh: Optional[Mesh] = None,
        device: torch.device | str = "cuda",
    ):
        """``device``: where the walkers run without a mesh; with one, its
        first shard's device takes its place."""
        if machine.n_inputs != hamiltonian.n_sites:
            raise ValueError("machine.n_inputs != hamiltonian.n_sites")
        if config.n_beta > 1 and config.n_walkers % config.n_beta != 0:
            raise ValueError("n_walkers must be a multiple of n_beta")
        if mesh is not None:
            if config.n_walkers % (mesh.size * config.n_beta) != 0:
                raise ValueError(
                    f"n_walkers ({config.n_walkers}) must be a multiple of "
                    f"mesh devices * n_beta ({mesh.size} * {config.n_beta}) so the "
                    "walker shards (and the beta=1 estimator slice) divide evenly"
                )
            if config.energy_dtype == "compensated":
                raise ValueError(
                    "energy_dtype='compensated' is a single-device anchor mode "
                    "(use energy_dtype=float64 under a mesh)"
                )
            device = mesh.devices[0]
        if config.solver not in SOLVER_NAMES:
            raise ValueError(f"solver must be one of {SOLVER_NAMES}, got {config.solver!r}")
        if config.n_accumulations > 1 and config.solver not in dense_solvers.SOLVERS:
            raise ValueError("n_accumulations > 1 requires a dense solver (reference parity)")
        if config.energy_dtype not in (None, "compensated", torch.float32, torch.float64):
            raise ValueError(f"energy_dtype must be None, torch.float32, torch.float64 or 'compensated', "
                             f"got {config.energy_dtype!r}")
        if config.energy_dtype == "compensated" and "compensated" not in hamiltonian.local_energy.__code__.co_varnames:
            raise ValueError(
                "energy_dtype='compensated' requires a Hamiltonian with a "
                "compensated local_energy (ising family)"
            )
        if config.solve_dtype not in (None, torch.float32, torch.float64):
            raise ValueError(f"solve_dtype must be None, torch.float32 or torch.float64, got {config.solve_dtype!r}")
        exchange = hamiltonian.sampler_kind == "exchange"
        if exchange and config.n_beta > 1 and config.use_fused_sweeps:
            raise ValueError(
                "use_fused_sweeps does not implement tempered exchange; "
                "set use_fused_sweeps=False with n_beta > 1"
            )
        if exchange and config.block_moves_per_sweep > 0:
            raise ValueError(
                "block_moves_per_sweep breaks particle conservation - "
                "not available with the Kawasaki exchange sampler"
            )
        if config.use_fused_sweeps and machine.dtype != torch.float32:
            raise ValueError("use_fused_sweeps requires a float32 machine")
        device = torch.device(device)
        if device.type != "cpu" and config.n_beta > MAX_NBETA:
            raise ValueError(f"n_beta={config.n_beta} on {device}: the kernels' ladder takes at most {MAX_NBETA}")
        if (wants_large_v_mixed_precision(machine, config.solver)
                and config.solve_dtype is None and config.energy_dtype is None):
            config = dataclasses.replace(config, solve_dtype=torch.float64)
        self.machine = machine
        self.hamiltonian = hamiltonian
        self.config = config
        self.mesh = mesh
        self.device = device
        self.schedule = torch.as_tensor(hamiltonian.schedule(), dtype=torch.int32, device=device)
        if exchange:
            self.bonds = torch.as_tensor(hamiltonian.bonds, dtype=torch.int32, device=device)
            n_unit, nb = hamiltonian.n_unit_steps, config.n_beta
            if nb > 1:  # tempered exchange: the in-kernel ladder on the card
                sweep = lambda work, state, n: kawasaki.tempered_exchange_sweeps(work, state, self.bonds, n, n_unit, nb)
            else:
                sweep = lambda work, state, n: kawasaki.exchange_sweeps(work, state, self.bonds, n, n_unit)
        elif config.n_beta > 1:
            sweep = lambda work, state, n: tempering.tempering_sweeps(work, state, self.schedule, n, config.n_beta)
        else:
            sweep = lambda work, state, n: metropolis.sweeps(work, state, self.schedule, n)
        if config.block_moves_per_sweep > 0:
            base_sweep, bmps, nb = sweep, config.block_moves_per_sweep, config.n_beta

            def sweep(work, state, n):
                state = base_sweep(work, state, n)
                beta = None
                if nb > 1:  # tempered chains accept block moves with their replica's beta
                    k = state.lnpsi.shape[0]
                    beta = replica_betas(nb, k // nb, state.cache.spins.dtype, state.cache.spins.device)
                return metropolis.block_flip_moves(work, state, n_moves=n * bmps, beta=beta)

        self._sweep = sweep
        # the precisions of the estimators (edt) and of the solve (sdt, never
        # narrower than edt), as the JAX package's _build_step sets them
        rdt = machine.dtype
        if config.energy_dtype == "compensated":
            edt = torch.float64  # htilda lands in f64
        else:
            edt = rdt if config.energy_dtype is None else config.energy_dtype
        sdt = edt if config.solve_dtype is None else config.solve_dtype
        self._energy_dtype = edt
        self._solve_dtype = max(sdt, edt, key=_bits)
        self._use_ema = config.precond_ema > 0.0 and config.solver in ("cg", "auto")
        self._diag_ema = self._ema_init()
        self.n_remediations = 0
        self.n_qlp_fallbacks = 0  # auto: steps whose CG hit its cap unconverged

    def _ema_init(self) -> Optional[torch.Tensor]:
        """A fresh diag(S) EMA carry (ones; step 0 overwrites it), as the
        JAX package starts one per run()."""
        if not self._use_ema:
            return None
        return torch.ones(self.machine.n_vars, dtype=self._solve_dtype, device=self.device)

    # ------------------------------------------------------------------
    def init(self, seed: int | None = None) -> tuple[Params, metropolis.MCState]:
        """Random parameters and the Hamiltonian's initial spins; one
        generator on the VMC's device serves both and then the sampler. Under
        a mesh the parameters are replicated and the state sharded."""
        g = make_generator(self.config.seed if seed is None else seed, self.device)
        params = self.machine.init_params(g)
        spins = self.hamiltonian.init_spins(g, self.config.n_walkers, self.machine.dtype)
        state = metropolis.init_state(self.machine.make_work(params), spins, g)
        return self.place(params, state)

    def place(self, params: Params, state: metropolis.MCState) -> tuple[Params, metropolis.MCState]:
        """(params, state) as this VMC runs them: under a mesh the parameters
        replicated (``replicate_tree``) and the walkers sharded
        (``shard_walker_tree``); without one as they are."""
        if self.mesh is None:
            return params, state
        return replicate_tree(params, self.mesh), shard_walker_tree(state, self.mesh, self.config.n_walkers)

    def warm_up(self, params: Params, state: metropolis.MCState, n_sweeps: int = 500) -> metropolis.MCState:
        return self._sweep(self.machine.make_work(params), state, n_sweeps)

    # ------------------------------------------------------------------
    def estimator_terms(self, params: Params, cache: Cache, lnpsi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(htilda, O) of one sampling round: the local energy and O_k in the
        energy dtype, cast to the solve dtype. A wider energy dtype
        recomputes y and ln psi from the spins with the widened parameters
        (exact given float32 parameters) before the local energy and O_k."""
        machine, ham = self.machine, self.hamiltonian
        # "compensated" is passed only when set: the exchange Hamiltonians take no such argument
        kw = {"compensated": True} if self.config.energy_dtype == "compensated" else {}
        edt = self._energy_dtype
        if edt != machine.dtype:
            wide = complex_dtype(edt)
            params = {k: v.to(wide) for k, v in params.items()}
            cache, lnpsi = shard_map(lambda w, s: engine.full_forward(w, s.to(edt)), machine.make_work(params),
                                     cache.spins)
        work = machine.make_work(params)
        if self.mesh is not None:  # no "compensated" under a mesh: kw is empty
            htilda = ham.local_energy_sharded(work, cache, lnpsi)
        else:
            htilda = ham.local_energy(work, cache, lnpsi, **kw)
        o_mat = shard_map(machine.grad_log, params, cache)
        sc = complex_dtype(self._solve_dtype)
        return shard_map(lambda h, o: (h.to(sc), o.to(sc)), htilda, o_mat)

    def _solve(self, o_mat: torch.Tensor, htilda: torch.Tensor, lam: float, step_idx: int, samples) -> tuple:
        """dx and the iteration count of the configured solver."""
        cfg, machine = self.config, self.machine
        pdiag = None
        if self._use_ema:
            # EMA of diag(S), seeded with the current estimate at step 0
            cur = sr_diag(o_mat, walker_mean(o_mat))
            rho = cfg.precond_ema
            self._diag_ema = cur if step_idx == 0 else rho * self._diag_ema + (1.0 - rho) * cur
            pdiag = self._diag_ema
        cap = min(cfg.cg_max_iters, machine.n_vars)
        if cfg.solver == "cg":
            dx, res = sr_cg_solve(o_mat, htilda, lam, tol=cfg.cg_tol, max_iters=cap, precond_diag=pdiag)
            return dx, res.iterations
        if cfg.solver == "auto":
            # CG, and MINRES-QLP where CG ends at its cap AND unconverged
            # (cg_solve's threshold tol^2 ||F||^2)
            dx, res = sr_cg_solve(o_mat, htilda, lam, tol=cfg.cg_tol, max_iters=cap, precond_diag=pdiag)
            threshold = (cfg.cg_tol * cfg.cg_tol) * float(force_vector(o_mat, htilda)[0].abs().square().sum())
            if res.iterations >= cap and res.residual_norm2 >= threshold:
                self.n_qlp_fallbacks += 1
                dx, res2 = sr_minres_solve(o_mat, htilda, lam, tol=cfg.cg_tol, max_iters=cfg.cg_max_iters)
                return dx, res.iterations + res2.iterations
            return dx, res.iterations
        if cfg.solver == "minresqlp":
            dx, res = sr_minres_solve(o_mat, htilda, lam, tol=cfg.cg_tol, max_iters=cfg.cg_max_iters)
            return dx, res.iterations
        if cfg.solver == "minsr":
            return sr_minsr_solve(o_mat, htilda, lam)[0], 0
        if cfg.solver == "sgd":
            return sgd_diag_solve(o_mat, htilda, lam), 0
        solver = dense_solvers.SOLVERS[cfg.solver]
        if samples is not None:
            return sr_dense_solve_accumulated(samples, lam, solver), 0
        return sr_dense_solve(o_mat, htilda, lam, solver), 0

    def sr_update(self, params: Params, cache: Cache, lnpsi: torch.Tensor, step_idx: int,
                  extra_rounds: tuple = ()) -> tuple[Params, SRStats]:
        """Everything after sampling: local energy, O_k, the solve, trust
        region and guards; returns the new parameters and the step's stats.
        ``extra_rounds``: the (cache, lnpsi) of the further sampling rounds
        of ``n_accumulations > 1``; <H> and the rsd then pool all rounds.
        Under a mesh the cache and ln psi are sharded, and so are O and the
        local energies; the solve's sums are reduced over the shards."""
        machine, cfg = self.machine, self.config
        htilda, o_mat = self.estimator_terms(params, cache, lnpsi)
        samples = None
        pooled = htilda
        if extra_rounds:
            samples = [(o_mat, htilda)] + [self.estimator_terms(params, c, ln)[::-1] for c, ln in extra_rounds]
            pooled = torch.cat([gather(h) for _, h in samples])
        havg, rsd = energy_and_rsd(pooled)
        lam = lambda_schedule(step_idx)
        dx, iters = self._solve(o_mat, htilda, lam, step_idx, samples)
        dx = dx.to(machine.complex_dtype)
        if cfg.max_dx_norm is not None:
            dx_norm = float(torch.sqrt((dx.real * dx.real + dx.imag * dx.imag).sum()))
            # a non-finite solve skips the update entirely
            scale = min(1.0, cfg.max_dx_norm / max(dx_norm, 1e-30)) if math.isfinite(dx_norm) else 0.0
            dx = dx * scale
        # freeze the update if <H> went non-finite or the energy variance
        # collapsed to zero (S and F are then exact zeros: the solve is noise);
        # the variance is the first round's, as in the JAX package
        var = float(walker_mean(htilda, lambda h: h.real**2 + h.imag**2) - (havg.real**2 + havg.imag**2))
        ok = math.isfinite(float(havg.real)) and var > 0.0
        new_params = machine.update_params(params, dx, cfg.learning_rate) if ok else params
        return new_params, SRStats(energy=havg, rsd=rsd, cg_iters=iters, lam=lam)

    def _estimator_rows(self, state: metropolis.MCState) -> tuple[Cache, torch.Tensor]:
        """The cache and ln psi the estimators read: all walkers, or with
        n_beta > 1 the beta = 1 replicas [::n_beta], copied contiguous for
        the kernels (per shard under a mesh: a shard holds whole replica
        groups, so its slices are the global slice's rows in order)."""
        nb = self.config.n_beta
        if nb == 1:
            return state.cache, state.lnpsi
        return shard_map(lambda c, ln: (Cache(*(x[::nb].contiguous() for x in c)), ln[::nb].contiguous()),
                         state.cache, state.lnpsi)

    def step(self, params: Params, state: metropolis.MCState, step_idx: int):
        """One SR iteration; returns (params, state, stats)."""
        cfg = self.config
        work = self.machine.make_work(params)
        state = self._sweep(work, state, cfg.n_sweeps_per_step)
        cache, lnpsi = self._estimator_rows(state)
        extra = []
        for _ in range(cfg.n_accumulations - 1):
            state = self._sweep(work, state, cfg.n_sweeps_per_step)
            extra.append(self._estimator_rows(state))
        params, stats = self.sr_update(params, cache, lnpsi, step_idx, extra_rounds=tuple(extra))
        cache, lnpsi = shard_map(engine.full_forward, self.machine.make_work(params), state.cache.spins)
        return params, state._replace(cache=cache, lnpsi=lnpsi), stats

    # ------------------------------------------------------------------
    def _can_escalate(self) -> bool:
        cfg = self.config
        if cfg.n_beta > 1 or cfg.collapse_escalate_nbeta < 0 or cfg.collapse_escalate_nbeta == 1:
            return False  # already tempered / escalation disabled
        if self.hamiltonian.sampler_kind == "exchange" and cfg.use_fused_sweeps:
            return False  # as in JAX: the fused exchange has no tempered ladder, reseed in the sector
        n_dev = n_devices(self.mesh)  # a shard must hold whole replica groups
        if cfg.collapse_escalate_nbeta == 0:
            return any(cfg.n_walkers % (n_dev * nb) == 0 for nb in _NBETA_CANDIDATES)
        return cfg.n_walkers % (n_dev * cfg.collapse_escalate_nbeta) == 0

    def _resolve_escalation_nbeta(self, params: Params, state: metropolis.MCState) -> int:
        """collapse_escalate_nbeta, or - when 0 - the measured-acceptance
        choice on the live, collapsed ensemble: tempering.tune_n_beta, or for
        an exchange Hamiltonian kawasaki.tune_n_beta_exchange (a flip probe
        would break the particle sectors)."""
        cfg = self.config
        if cfg.collapse_escalate_nbeta > 1:
            return cfg.collapse_escalate_nbeta
        work = self.machine.make_work(params)
        if self.hamiltonian.sampler_kind == "exchange":
            nb, diags = kawasaki.tune_n_beta_exchange(work, state, self.bonds, self.hamiltonian.n_unit_steps,
                                                      candidates=_NBETA_CANDIDATES, n_devices=n_devices(self.mesh))
        else:
            nb, diags = tempering.tune_n_beta(work, state, self.schedule, candidates=_NBETA_CANDIDATES,
                                              n_devices=n_devices(self.mesh))
        for cand, d in diags.items():
            print(f"#   n_beta={cand}: swap/pair = "
                  + "/".join(f"{a:.2f}" for a in d["swap"])
                  + "  flip/replica = " + "/".join(f"{a:.2f}" for a in d["flip"]))
        return nb

    def _reseed_state(self, params: Params, state: metropolis.MCState) -> metropolis.MCState:
        """Replace collapse_reseed_frac of the walkers with fresh random
        configurations (drawn for all K walkers, under a mesh then sharded);
        caches recomputed."""
        cfg = self.config
        stride = max(1, int(round(1.0 / max(cfg.collapse_reseed_frac, 1e-9))))
        rand = self.hamiltonian.reseed_spins(state.generator, cfg.n_walkers, state.cache.spins.dtype)
        keep = (torch.arange(cfg.n_walkers, device=rand.device) % stride) != 0
        spins = torch.where(keep[:, None], gather(state.cache.spins), rand)
        if self.mesh is not None:
            spins = shard_walker_tree(spins, self.mesh, cfg.n_walkers)
        cache, lnpsi = shard_map(engine.full_forward, self.machine.make_work(params), spins)
        return state._replace(cache=cache, lnpsi=lnpsi)

    def run(
        self,
        params: Params,
        state: metropolis.MCState,
        n_iterations: int,
        callback: Optional[Callable[[int, SRStats], None]] = None,
        verbose: bool = False,
        checkpoint_fn: Optional[Callable[[int, Params, metropolis.MCState], None]] = None,
        checkpoint_every: int = 100,
        start_step: int = 0,
    ):
        """Optimization loop with RSD early stop, NaN stop and collapse
        remediation; returns (params, state, history, elapsed_seconds).

        As in the JAX package: with steps_per_host_loop = m > 1 whole chunks
        of m steps run before the stops are checked (so a stop inside a
        chunk ends the history there, with the chunk's later steps already
        taken), acceptance is measured per chunk, and checkpoint_fn(step,
        params, state) is called after a chunk that crosses a multiple of
        checkpoint_every. start_step offsets the lambda schedule, the
        history and the checkpoints for a resumed run. A collapsed run
        (rsd pinned at zero for collapse_patience steps) escalates to
        parallel tempering with the remaining iterations, or reseeds."""
        cfg = self.config
        history = []
        t0 = time.perf_counter()
        self._diag_ema = self._ema_init()  # a fresh carry per run, as in JAX
        m = cfg.steps_per_host_loop
        n = 0
        stop = False
        prev_acc, prev_prop = 0.0, 0.0
        collapse_run = 0
        while n < n_iterations and not stop:
            chunk = []
            for i in range(m if m > 1 and n + m <= n_iterations else 1):
                params, state, stats = self.step(params, state, start_step + n + i)
                chunk.append(stats)
            na, np_ = float(state.n_accepted), float(state.n_proposed)
            acc = (na - prev_acc) / max(np_ - prev_prop, 1.0)
            prev_acc, prev_prop = na, np_
            if checkpoint_fn is not None and (start_step + n + len(chunk)) // checkpoint_every > (start_step + n) // checkpoint_every:
                checkpoint_fn(start_step + n + len(chunk), params, state)
            for stats in chunk:
                e_re, rsd = float(stats.energy.real), float(stats.rsd)
                step = start_step + n
                history.append({"step": step, "energy": e_re, "rsd": rsd, "cg_iters": stats.cg_iters, "acceptance": acc})
                if callback is not None:
                    callback(step, stats)
                if verbose:
                    print(f"{step + 1:5d}  {e_re:+.7f}  rsd={rsd:.3e}  cg={stats.cg_iters}")
                n += 1
                if not math.isfinite(e_re):
                    print('# "Havg" has non-value type. We stop here.')
                    stop = True
                    break
                collapsed = rsd < _COLLAPSE_RSD
                collapse_run = collapse_run + 1 if collapsed else 0
                if cfg.rsd_cutoff is not None and rsd < cfg.rsd_cutoff and not (collapsed and cfg.auto_remediate):
                    if verbose:
                        print("# We got a converged solution.")
                    stop = True
                    break
            if not stop and cfg.auto_remediate and collapse_run >= cfg.collapse_patience and n < n_iterations:
                collapse_run = 0
                self.n_remediations += 1
                if self._can_escalate():
                    esc_nbeta = self._resolve_escalation_nbeta(params, state)
                    print(
                        f"# walker collapse at step {start_step + n}: escalating to "
                        f"parallel tempering (n_beta={esc_nbeta}"
                        + (", auto-tuned from swap acceptance)" if cfg.collapse_escalate_nbeta == 0 else ")")
                    )
                    esc = VMC(self.machine, self.hamiltonian, dataclasses.replace(cfg, n_beta=esc_nbeta),
                              mesh=self.mesh, device=self.device)
                    esc.n_remediations = self.n_remediations
                    # the walkers become replica-minor groups (betas by
                    # position); their caches are consistent as they are
                    p2, s2, hist2, _ = esc.run(
                        params, state, n_iterations - n,
                        callback=callback, verbose=verbose,
                        checkpoint_fn=checkpoint_fn, checkpoint_every=checkpoint_every,
                        start_step=start_step + n,
                    )
                    self.n_remediations = esc.n_remediations
                    return p2, s2, history + hist2, time.perf_counter() - t0
                print(
                    f"# walker collapse at step {start_step + n}: reseeding "
                    f"{cfg.collapse_reseed_frac:.0%} of walkers + "
                    f"{cfg.collapse_requil_sweeps} re-equilibration sweeps"
                )
                state = self._reseed_state(params, state)
                state = self.warm_up(params, state, cfg.collapse_requil_sweeps)
        return params, state, history, time.perf_counter() - t0
