"""High-level VMC ground-state optimization driver.

One SR iteration:

    sweeps  ->  local energy  ->  O_k  ->  SR-CG solve  ->
    theta -= lr * dx    ->  recompute caches from the current spins

with the lambda schedule, the ||dx|| trust region, the NaN and
zero-variance guards and the RSD early stop. The iteration runs eagerly as
a Python loop. On the card each sweep is one launch of the sweep kernel
and the off-diagonal local energy one launch of the energy kernel (float32
only: another machine dtype on the card raises); on the CPU both run as
plain PyTorch.

Options of the JAX package's VMCConfig that this package does not
implement yet (tempering, meshes, other solvers, ...) raise
NotImplementedError; none is ignored.
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
from neural_network_quantum_state_tpu_torch.optim.sr import SRStats, energy_and_rsd, lambda_schedule, sr_cg_solve
from neural_network_quantum_state_tpu_torch.sampler import metropolis


@dataclasses.dataclass(frozen=True)
class VMCConfig:
    """Field for field the JAX package's VMCConfig, with the same defaults."""

    n_walkers: int = 1024
    n_sweeps_per_step: int = 1  # reference "nms"
    n_accumulations: int = 1  # dense solvers only (not implemented here)
    learning_rate: float = 1e-2
    solver: str = "cg"  # only "cg" is implemented
    cg_tol: float = 1e-5
    cg_max_iters: int = 1000
    rsd_cutoff: Optional[float] = None  # early stop
    n_beta: int = 1  # >1: parallel tempering (not implemented)
    # Trust region on ||S^-1 F||: near-singular solves on a collapsed walker
    # distribution emit huge steps that can pin the sampler. None disables.
    max_dx_norm: Optional[float] = 1.0
    # Each step is one iteration of run()'s Python loop whatever this says;
    # the RSD early stop is checked after every step.
    steps_per_host_loop: int = 1
    # Parity with the JAX package: requires a float32 machine and selects
    # nothing, since the card always runs the sweep kernel.
    use_fused_sweeps: bool = False
    block_moves_per_sweep: int = 0  # not implemented
    # torch.float64: S/F reductions and the solve in f64. Defaulted to f64
    # for an f32 CG solve at V >= LARGE_V_THRESHOLD.
    solve_dtype: Optional[Any] = None
    energy_dtype: Optional[Any] = None  # not implemented
    # Collapse remediation: rsd pinned at zero for collapse_patience steps.
    # Escalation to tempering is not implemented and raises when due; the
    # reseed path (collapse_escalate_nbeta = 1 or < 0, or a walker count no
    # ladder divides) is.
    auto_remediate: bool = True
    collapse_patience: int = 3
    collapse_escalate_nbeta: int = 4
    collapse_reseed_frac: float = 0.5
    collapse_requil_sweeps: int = 100
    precond_ema: float = 0.0  # not implemented
    seed: int = 0


LARGE_V_THRESHOLD = 500
_NBETA_CANDIDATES = (2, 4, 6, 8, 12, 16)
# Below any honest Monte-Carlo relative standard deviation: rsd this small
# only happens when every walker is pinned on one configuration.
_COLLAPSE_RSD = 1e-12


def _not_implemented(config: VMCConfig) -> list[str]:
    bad = []
    if config.solver != "cg":
        bad.append(f"solver={config.solver!r} (only 'cg')")
    if config.n_beta != 1:
        bad.append(f"n_beta={config.n_beta} (parallel tempering)")
    if config.energy_dtype is not None:
        bad.append(f"energy_dtype={config.energy_dtype!r}")
    if config.precond_ema != 0.0:
        bad.append(f"precond_ema={config.precond_ema}")
    if config.block_moves_per_sweep != 0:
        bad.append(f"block_moves_per_sweep={config.block_moves_per_sweep}")
    return bad


class VMC:
    def __init__(
        self,
        machine: Machine,
        hamiltonian: Hamiltonian,
        config: VMCConfig = VMCConfig(),
        mesh: Optional[Any] = None,
        device: torch.device | str = "cuda",
    ):
        if machine.n_inputs != hamiltonian.n_sites:
            raise ValueError("machine.n_inputs != hamiltonian.n_sites")
        if mesh is not None:
            raise NotImplementedError("VMC(mesh=...): multi-device walker sharding is not ported yet")
        bad = _not_implemented(config)
        if bad:
            raise NotImplementedError("VMCConfig options not ported yet: " + ", ".join(bad))
        if config.n_accumulations > 1:
            raise ValueError("n_accumulations > 1 requires a dense solver (reference parity)")
        if config.use_fused_sweeps and machine.dtype != torch.float32:
            raise ValueError("use_fused_sweeps requires a float32 machine")
        device = torch.device(device)
        if device.type != "cpu" and machine.dtype != torch.float32:
            raise NotImplementedError(f"{machine.dtype} on {device}: only float32 kernels are ported (use device='cpu')")
        if config.solve_dtype not in (None, torch.float32, torch.float64):
            raise ValueError(f"solve_dtype must be None, torch.float32 or torch.float64, got {config.solve_dtype!r}")
        if machine.n_vars >= LARGE_V_THRESHOLD and machine.dtype == torch.float32 and config.solve_dtype is None:
            # a pure-f32 CG solve at V >~ 500 stagnates on roundoff; f64 is cheap
            config = dataclasses.replace(config, solve_dtype=torch.float64)
        self.machine = machine
        self.hamiltonian = hamiltonian
        self.config = config
        self.device = device
        self.schedule = torch.as_tensor(hamiltonian.schedule(), dtype=torch.int32, device=device)
        self._solve_cdtype = complex_dtype(config.solve_dtype or machine.dtype)
        self.n_remediations = 0

    # ------------------------------------------------------------------
    def init(self, seed: int | None = None) -> tuple[Params, metropolis.MCState]:
        """Random parameters and the Hamiltonian's initial spins; one
        generator on the VMC's device serves both and then the sampler."""
        g = make_generator(self.config.seed if seed is None else seed, self.device)
        params = self.machine.init_params(g)
        spins = self.hamiltonian.init_spins(g, self.config.n_walkers, self.machine.dtype)
        state = metropolis.init_state(self.machine.make_work(params), spins, g)
        return params, state

    def warm_up(self, params: Params, state: metropolis.MCState, n_sweeps: int = 500) -> metropolis.MCState:
        return metropolis.sweeps(self.machine.make_work(params), state, self.schedule, n_sweeps)

    # ------------------------------------------------------------------
    def sr_update(self, params: Params, cache: Cache, lnpsi: torch.Tensor, step_idx: int) -> tuple[Params, SRStats]:
        """Everything after sampling: local energy, O_k, SR-CG solve, trust
        region and guards; returns the new parameters and the step's stats."""
        machine, ham, cfg = self.machine, self.hamiltonian, self.config
        htilda = ham.local_energy(machine.make_work(params), cache, lnpsi)
        o_mat = machine.grad_log(params, cache)
        htilda, o_mat = htilda.to(self._solve_cdtype), o_mat.to(self._solve_cdtype)
        havg, rsd = energy_and_rsd(htilda)
        lam = lambda_schedule(step_idx)
        dx, res = sr_cg_solve(o_mat, htilda, lam, tol=cfg.cg_tol, max_iters=min(cfg.cg_max_iters, machine.n_vars))
        dx = dx.to(machine.complex_dtype)
        if cfg.max_dx_norm is not None:
            dx_norm = float(torch.sqrt((dx.real * dx.real + dx.imag * dx.imag).sum()))
            # a non-finite solve skips the update entirely
            scale = min(1.0, cfg.max_dx_norm / max(dx_norm, 1e-30)) if math.isfinite(dx_norm) else 0.0
            dx = dx * scale
        # freeze the update if <H> went non-finite or the energy variance
        # collapsed to zero (S and F are then exact zeros: the solve is noise)
        var = float((htilda.real**2 + htilda.imag**2).mean() - (havg.real**2 + havg.imag**2))
        ok = math.isfinite(float(havg.real)) and var > 0.0
        new_params = machine.update_params(params, dx, cfg.learning_rate) if ok else params
        return new_params, SRStats(energy=havg, rsd=rsd, cg_iters=res.iterations, lam=lam)

    def step(self, params: Params, state: metropolis.MCState, step_idx: int):
        """One SR iteration; returns (params, state, stats)."""
        state = metropolis.sweeps(self.machine.make_work(params), state, self.schedule, self.config.n_sweeps_per_step)
        params, stats = self.sr_update(params, state.cache, state.lnpsi, step_idx)
        cache, lnpsi = engine.full_forward(self.machine.make_work(params), state.cache.spins)
        return params, state._replace(cache=cache, lnpsi=lnpsi), stats

    # ------------------------------------------------------------------
    def _can_escalate(self) -> bool:
        cfg = self.config
        if cfg.collapse_escalate_nbeta < 0 or cfg.collapse_escalate_nbeta == 1:
            return False
        if cfg.collapse_escalate_nbeta == 0:
            return any(cfg.n_walkers % nb == 0 for nb in _NBETA_CANDIDATES)
        return cfg.n_walkers % cfg.collapse_escalate_nbeta == 0

    def _reseed_state(self, params: Params, state: metropolis.MCState) -> metropolis.MCState:
        """Replace collapse_reseed_frac of the walkers with fresh random
        configurations; caches recomputed."""
        cfg = self.config
        stride = max(1, int(round(1.0 / max(cfg.collapse_reseed_frac, 1e-9))))
        rand = self.hamiltonian.reseed_spins(state.generator, cfg.n_walkers, state.cache.spins.dtype)
        keep = (torch.arange(cfg.n_walkers, device=rand.device) % stride) != 0
        spins = torch.where(keep[:, None], state.cache.spins, rand)
        cache, lnpsi = engine.full_forward(self.machine.make_work(params), spins)
        return state._replace(cache=cache, lnpsi=lnpsi)

    def run(
        self,
        params: Params,
        state: metropolis.MCState,
        n_iterations: int,
        callback: Optional[Callable[[int, SRStats], None]] = None,
        verbose: bool = False,
        start_step: int = 0,
    ):
        """Optimization loop with RSD early stop, NaN stop and collapse
        remediation; returns (params, state, history, elapsed_seconds)."""
        cfg = self.config
        history = []
        t0 = time.perf_counter()
        prev_acc, prev_prop = 0.0, 0.0
        collapse_run = 0
        for n in range(n_iterations):
            step = start_step + n
            params, state, stats = self.step(params, state, step)
            na, np_ = float(state.n_accepted), float(state.n_proposed)
            acc = (na - prev_acc) / max(np_ - prev_prop, 1.0)
            prev_acc, prev_prop = na, np_
            e_re, rsd = float(stats.energy.real), float(stats.rsd)
            history.append({"step": step, "energy": e_re, "rsd": rsd, "cg_iters": stats.cg_iters, "acceptance": acc})
            if callback is not None:
                callback(step, stats)
            if verbose:
                print(f"{step + 1:5d}  {e_re:+.7f}  rsd={rsd:.3e}  cg={stats.cg_iters}")
            if not math.isfinite(e_re):
                print('# "Havg" has non-value type. We stop here.')
                break
            collapsed = rsd < _COLLAPSE_RSD
            collapse_run = collapse_run + 1 if collapsed else 0
            if cfg.rsd_cutoff is not None and rsd < cfg.rsd_cutoff and not (collapsed and cfg.auto_remediate):
                if verbose:
                    print("# We got a converged solution.")
                break
            if cfg.auto_remediate and collapse_run >= cfg.collapse_patience and n + 1 < n_iterations:
                collapse_run = 0
                self.n_remediations += 1
                if self._can_escalate():
                    raise NotImplementedError(
                        f"walker collapse at step {step + 1}: escalation to parallel tempering "
                        "is not ported yet (set collapse_escalate_nbeta=1 to reseed instead)"
                    )
                print(
                    f"# walker collapse at step {step + 1}: reseeding "
                    f"{cfg.collapse_reseed_frac:.0%} of walkers + "
                    f"{cfg.collapse_requil_sweeps} re-equilibration sweeps"
                )
                state = self._reseed_state(params, state)
                state = self.warm_up(params, state, cfg.collapse_requil_sweeps)
        return params, state, history, time.perf_counter() - t0
