"""Increment-trick Renyi-2 estimator (ratio / "glued ensemble" method; the
JAX package's ``measurements/renyi_increment.py``).

The direct swap estimator (estimators.renyi2_entropy; reference
impl_meas.cuh:57-142) averages exp(ln3 + ln4 - ln1 - ln2) over two
independent |psi|^2 replicas. At half-chain l = N/2 with S2 ~ 1 that
observable is exponentially small on typical samples and heavy-tailed, so
finite sampling is systematically biased LOW. This module implements the
standard fix (Hastings, Gonzalez, Kallin, Melko, PRL 104, 157201 (2010)):
write

    Tr rho_A^2 = prod_{j=0}^{l-1}  q_{j+1} / q_j,      A_j = sites [0, j)

with q_j = <SWAP_{A_j}> and estimate each ratio in the *glued* (tilted)
ensemble

    W_j(s1, s2) = |psi(s1) psi(s2) psi(s3^j) psi(s4^j)|,
    s3^j = s1 on A_j else s2,   s4^j = s2 on A_j else s1,

where the increment observable

    O_j = phi_j * g_{j+1}/g_j,      g_j = psi(s3^j) psi(s4^j),
    phi_j = conj(psi(s1) psi(s2)) g_j / |psi(s1) psi(s2) g_j|   (pure phase)

is O(1): g_{j+1}/g_j only touches the single site j (a per-walker flip
ratio on each glued cache, zero when s1_j == s2_j). Then

    q_{j+1}/q_j = <O_j>_{W_j} / <phi_j>_{W_j}.

Every level is more batch: the state holds l * walkers_per_level walkers
(levels-major), each walker carrying its own region mask row. Four coupled
log-cosh caches (s1, s2, s3, s4) advance in lock-step; a single-site
Metropolis proposal on replica 1 touches cache 1 and exactly one of caches
3/4 (site in / out of A_j), so the acceptance ratio is a product of two
incremental O(K*H) flip ratios on the Work/Cache engine (ops/engine.py).
Note the first-power acceptance exp(d), not exp(2d): W_j carries each
amplitude to the first power.

The glued sweeps are plain PyTorch on every device (the JAX package runs
them in XLA; no TPU kernel computes them). Their draws are separate from
their update (``glued_draws``, ``glued_sweep``), so that a test can feed
shared uniforms; ``glued_sweeps`` draws one sweep's block at a time from
the state's generator. With ``mesh=`` the levels x walkers batch is sharded
over a walker mesh, as in the JAX package: each sweep's block is drawn for
all walkers, every shard sweeps on its columns of it, and the observables
are taken per shard and gathered, so a mesh run gives the one-device run's
chains.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from neural_network_quantum_state_tpu_torch.measurements.estimators import _blocked_jackknife
from neural_network_quantum_state_tpu_torch.measurements.sampler import (
    check_shards,
    generator_for,
    run_chunked,
    run_pair_estimator,
)
from neural_network_quantum_state_tpu_torch.ops import engine
from neural_network_quantum_state_tpu_torch.ops.engine import Cache, Work
from neural_network_quantum_state_tpu_torch.ops.logcosh import logcosh
from neural_network_quantum_state_tpu_torch.ops.rng import random_spins, uniform_block
from neural_network_quantum_state_tpu_torch.ops.sweep import replica_betas
from neural_network_quantum_state_tpu_torch.parallel.mesh import (
    Sharded,
    gather,
    reduce_sum,
    shard_map,
    shard_walker_tree,
    split,
)


class GluedState(NamedTuple):
    """Four coupled walker ensembles + the sampler's generator and counters.

    Invariant: c3.spins == where(mask, c1.spins, c2.spins) and
    c4.spins == where(mask, c2.spins, c1.spins) at all times.
    """

    c1: Cache
    c2: Cache
    c3: Cache
    c4: Cache
    ln1: torch.Tensor  # (K,) complex
    ln2: torch.Tensor
    ln3: torch.Tensor
    ln4: torch.Tensor
    generator: torch.Generator
    n_accepted: torch.Tensor  # () float64
    n_proposed: torch.Tensor  # () float64


def init_glued(work: Work, s1: torch.Tensor, s2: torch.Tensor, mask: torch.Tensor,
               generator: torch.Generator) -> GluedState:
    """Build the 4-cache state from replica spins (K, N) and region mask (K, N)."""
    s3 = torch.where(mask, s1, s2)
    s4 = torch.where(mask, s2, s1)
    c1, ln1 = engine.full_forward(work, s1)
    c2, ln2 = engine.full_forward(work, s2)
    c3, ln3 = engine.full_forward(work, s3)
    c4, ln4 = engine.full_forward(work, s4)
    zero = torch.zeros((), dtype=torch.float64, device=s1.device)
    return GluedState(c1, c2, c3, c4, ln1, ln2, ln3, ln4, generator, zero, zero.clone())


def _select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-walker where over the leading axis."""
    return torch.where(cond.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)


def _commit(cache: Cache, site: int, y1: torch.Tensor, sa1: torch.Tensor, accept: torch.Tensor) -> Cache:
    """The cache with the flip of `site` (candidate y1, sa1) taken where
    `accept`; the input is left unchanged."""
    spins = cache.spins.clone()
    spins[:, site] = torch.where(accept, -cache.spins[:, site], cache.spins[:, site])
    return Cache(spins, _select(accept, y1, cache.y), torch.where(accept, sa1, cache.sa))


def _propose(work: Work, cp: Cache, lnp, ca: Cache, lna, cb: Cache, lnb, in_reg, site: int, u, beta=None):
    """One Metropolis proposal: flip `site` in the primary replica (cp) and
    in its glued partner - cache `ca` where in_reg, cache `cb` elsewhere.

    ``beta``: optional (K,) per-walker inverse temperatures - the glued PT
    ladder samples W_j^beta, so the tempered accept prob is min(1, e^{beta*d}).
    Both candidates (the primary's flip and the flip of the per-walker
    selection of ``ca`` and ``cb``) are evaluated in one batched log-cosh,
    and an accepted flip takes the candidate's y and sa (the engine's
    ``flip_log_psi`` and ``commit_flip`` arithmetic).

    Returns the six updated (cache, lnpsi) plus the per-walker accept mask.
    """
    partner = Cache(*(_select(in_reg, xa, xb) for xa, xb in zip(ca, cb)))
    lng = torch.where(in_reg, lna, lnb)
    two_s = 2.0 * torch.stack((cp.spins[:, site], partner.spins[:, site]))  # (2, K)
    y1 = torch.stack((cp.y, partner.y)) - two_s[..., None] * work.w[site]  # (2, K, H)
    sa1 = torch.stack((cp.sa, partner.sa))
    if work.a is not None:
        sa1 = sa1 - two_s * work.a[site]
    lnp1, lng1 = engine._hidden_sum(work, logcosh(y1)) + sa1
    d = (lnp1.real - lnp.real) + (lng1.real - lng.real)
    if beta is not None:
        d = beta * d
    # first-power weight |psi1 psi2 psi3 psi4|: accept prob = min(1, e^d)
    accept = u < torch.exp(torch.clamp(d, max=0.0))
    acc_a, acc_b = accept & in_reg, accept & ~in_reg
    cp = _commit(cp, site, y1[0], sa1[0], accept)
    ca = _commit(ca, site, y1[1], sa1[1], acc_a)
    cb = _commit(cb, site, y1[1], sa1[1], acc_b)
    lnp = torch.where(accept, lnp1, lnp)
    lna = torch.where(acc_a, lng1, lna)
    lnb = torch.where(acc_b, lng1, lnb)
    return cp, lnp, ca, lna, cb, lnb, accept


def _glued_swap_phase(caches, lns, u: torch.Tensor, parity: int, n_beta: int):
    """One PT swap phase for the glued ensemble: pairs (r, r+1) with
    r = parity mod 2, replica-minor (walker w = c*nBeta + r - the partner
    geometry of ops.sweep.swap_phase).

    The sampled weight is FIRST-power, W_j^beta with
    ln W_j = Re(ln1 + ln2 + ln3 + ln4), so the swap accept prob is
    exp(dbeta * (ln W_upper - ln W_lower)) with dbeta = 1/nBeta, and an
    accepted swap exchanges the ENTIRE per-walker glued state (all four
    caches + lnpsi's). Swap partners always share a level (callers enforce
    walkers_per_level % n_beta == 0), so the per-walker region masks agree.
    """
    lnw = sum(ln.real for ln in lns)
    k_tot = lnw.shape[0]
    idx = torch.arange(k_tot, device=lnw.device)
    r = idx % n_beta
    in_pair_lower = ((r - parity) % 2 == 0) & (r >= parity) & (r + 1 < n_beta)
    in_pair_upper = ((r - parity) % 2 == 1) & (r > parity)
    partner = torch.where(in_pair_lower, idx + 1, torch.where(in_pair_upper, idx - 1, idx))

    dbeta = 1.0 / n_beta
    dln = lnw[partner] - lnw
    acc_lower = in_pair_lower & (u < torch.clamp(torch.exp(dbeta * dln), max=1.0))
    acc = acc_lower | acc_lower[partner]

    def gather(x):
        return _select(acc, x[partner], x)

    caches = tuple(Cache(*map(gather, c)) for c in caches)
    lns = tuple(gather(ln) for ln in lns)
    return caches, lns, acc_lower


def glued_draws(g: torch.Generator, k: int, n_sites: int, n_beta: int, dtype=torch.float32):
    """One sweep's draws from the generator: the (n_sites, 2, K) proposal
    uniforms (replica 1, then replica 2, at each site) and, for n_beta > 1,
    the (2, K) swap uniforms of its even- and odd-pair phases (drawn after
    the proposals')."""
    uniforms = uniform_block(g, (n_sites, 2, k), dtype)
    return uniforms, uniform_block(g, (2, k), dtype) if n_beta > 1 else None


def glued_sweep(work: Work, state: GluedState, sites, mask: torch.Tensor, uniforms: torch.Tensor,
                swap_uniforms: torch.Tensor | None = None, n_beta: int = 1) -> GluedState:
    """One sweep on the given draws: for each site of ``sites`` (a sequence
    of ints) a proposal on replica 1 (uniforms[t, 0]) then on replica 2
    (uniforms[t, 1]); with n_beta > 1 (tempered proposals at
    beta_r = (nBeta - r)/nBeta, replica-minor within each level's block)
    then the even- and the odd-pair whole-state swaps on swap_uniforms[0]
    and [1]. The counters count the accepted and the proposed flips."""
    c1, c2, c3, c4 = state.c1, state.c2, state.c3, state.c4
    ln1, ln2, ln3, ln4 = state.ln1, state.ln2, state.ln3, state.ln4
    k = ln1.shape[0]
    beta = None
    if n_beta > 1:
        if k % n_beta != 0:
            raise ValueError(f"glued sweeps: walkers ({k}) must be a multiple of n_beta ({n_beta})")
        beta = replica_betas(n_beta, k // n_beta, c1.spins.dtype, c1.spins.device)
    n_acc = torch.zeros((), dtype=torch.float64, device=ln1.device)
    for t, site in enumerate(sites):
        in_reg = mask[:, site]
        # replica 1 lives on s3 inside A_j, on s4 outside
        c1, ln1, c3, ln3, c4, ln4, a1 = _propose(work, c1, ln1, c3, ln3, c4, ln4, in_reg, site, uniforms[t, 0], beta)
        # replica 2 lives on s4 inside A_j, on s3 outside
        c2, ln2, c4, ln4, c3, ln3, a2 = _propose(work, c2, ln2, c4, ln4, c3, ln3, in_reg, site, uniforms[t, 1], beta)
        n_acc = n_acc + a1.sum(dtype=torch.float64) + a2.sum(dtype=torch.float64)
    if n_beta > 1:
        caches, lns = (c1, c2, c3, c4), (ln1, ln2, ln3, ln4)
        for parity in (0, 1):
            caches, lns, _ = _glued_swap_phase(caches, lns, swap_uniforms[parity], parity, n_beta)
        (c1, c2, c3, c4), (ln1, ln2, ln3, ln4) = caches, lns
    return GluedState(c1, c2, c3, c4, ln1, ln2, ln3, ln4, state.generator,
                      state.n_accepted + n_acc, state.n_proposed + float(2 * len(sites) * k))


def glued_sweeps(work: Work, state: GluedState, schedule, mask: torch.Tensor, n_sweeps: int,
                 n_beta: int = 1) -> GluedState:
    """Advance ``n_sweeps`` full sweeps; one sweep = len(schedule) sites x
    two proposals (replica 1 then replica 2) per site, each sweep on one
    ``glued_draws`` block from the state's generator.

    ``n_beta`` > 1 runs the glued PT ladder (replica-minor within each
    level's walker block, beta_r = (nBeta - r)/nBeta): tempered proposals
    sample W_j^beta and each sweep ends with even- then odd-pair whole-state
    swaps. Estimators must then read the beta=1 slice ``[::n_beta]``.

    A sharded state (``Sharded`` caches, ln psi and ``mask``) sweeps each
    shard on its columns of the block; the counters add the shards'."""
    sites = torch.as_tensor(schedule).tolist()
    k = state.ln1.shape[0]
    for _ in range(n_sweeps):
        uniforms, swaps = glued_draws(state.generator, k, len(sites), n_beta, state.c1.spins.dtype)
        if not isinstance(state.ln1, Sharded):
            state = glued_sweep(work, state, sites, mask, uniforms, swaps, n_beta)
            continue
        zero = torch.zeros_like(state.n_accepted)
        parts = shard_map(lambda w, st, m, u, sw: glued_sweep(w, st, sites, m, u, sw, n_beta),
                          work, state._replace(n_accepted=zero, n_proposed=zero), mask,
                          split(uniforms, state.ln1, 2), split(swaps, state.ln1, 1))
        state = parts._replace(generator=state.generator, n_accepted=state.n_accepted + reduce_sum(parts.n_accepted),
                               n_proposed=state.n_proposed + reduce_sum(parts.n_proposed))
    return state


def _increment_observable(work: Work, state: GluedState, inc_site: torch.Tensor):
    """Per-walker complex (num, den) of the level ratio:

    num = phi_j * g_{j+1}/g_j,   den = phi_j.

    g_{j+1}/g_j flips site j (= inc_site, per walker) in BOTH glued caches
    when s1_j != s2_j (otherwise A_{j+1} and A_j glue identically: ratio 1).
    """
    k = torch.arange(state.c1.spins.shape[0], device=inc_site.device)
    differ = state.c1.spins[k, inc_site] != state.c2.spins[k, inc_site]
    d = (engine.flip_log_psi_per_walker(work, state.c3, inc_site) - state.ln3
         + engine.flip_log_psi_per_walker(work, state.c4, inc_site) - state.ln4)
    d = torch.where(differ, d, torch.zeros_like(d))
    # phi = conj(psi1 psi2) g_j / |...|  (pure phase)
    phase = state.ln3.imag + state.ln4.imag - state.ln1.imag - state.ln2.imag
    num = torch.exp(torch.complex(d.real, d.imag + phase))
    den = torch.exp(torch.complex(torch.zeros_like(phase), phase))
    return num, den


def _orbit_increment_observable(work: Work, state: GluedState, mask: torch.Tensor, inc_site: torch.Tensor):
    """Z2-orbit-quadrature increment observable: Rao-Blackwellize the
    per-walker (num, den) of ``_increment_observable`` over the 4-element
    global-flip orbit {+-s1} x {+-s2} of the glued ensemble.

    For each orbit element (a, b) the glued configurations are rebuilt as
    t3 = glue(a s1, b s2), t4 = glue(b s2, a s1) and the level ratio is
    evaluated there, weighted by the actual sampling weight
    W_j(a s1, b s2) = |psi(a s1) psi(b s2) psi(t3) psi(t4)| (first power).
    The orbit-average identity makes the quadrature EXACTLY unbiased for
    any psi (no Z2 symmetry assumed); its point is deep-ordered cat-like
    states, where the glued single-flip chains freeze in one Neel sector
    and the pure increment chain inherits a per-level freeze bias - the
    quadrature restores the sector average analytically at EVERY level.

    Cost: 14 extra full batched forwards per measurement step (2 for
    -s1/-s2 + 4 glued + 2 flip-site forwards per non-identity orbit
    element); the identity element reuses the incremental caches.
    """
    kidx = torch.arange(state.c1.spins.shape[0], device=inc_site.device)
    s1, s2 = state.c1.spins, state.c2.spins

    def flip_at(t):
        t = t.clone()
        t[kidx, inc_site] = -t[kidx, inc_site]
        return t

    ln_a = {1.0: state.ln1, -1.0: engine.log_psi(work, -s1)}
    ln_b = {1.0: state.ln2, -1.0: engine.log_psi(work, -s2)}

    zs, nums, dens = [], [], []
    for a in (1.0, -1.0):
        for b in (1.0, -1.0):
            lna, lnb = ln_a[a], ln_b[b]
            if a > 0 and b > 0:
                ln3, ln4 = state.ln3, state.ln4
                d3 = engine.flip_log_psi_per_walker(work, state.c3, inc_site) - ln3
                d4 = engine.flip_log_psi_per_walker(work, state.c4, inc_site) - ln4
            else:
                t3 = torch.where(mask, a * s1, b * s2)
                t4 = torch.where(mask, b * s2, a * s1)
                ln3 = engine.log_psi(work, t3)
                ln4 = engine.log_psi(work, t4)
                d3 = engine.log_psi(work, flip_at(t3)) - ln3
                d4 = engine.log_psi(work, flip_at(t4)) - ln4
            differ = (a * s1[kidx, inc_site]) != (b * s2[kidx, inc_site])
            d = torch.where(differ, d3 + d4, torch.zeros_like(d3))
            phase = ln3.imag + ln4.imag - lna.imag - lnb.imag
            zs.append(lna.real + lnb.real + ln3.real + ln4.real)  # ln W_j at (a, b)
            nums.append(torch.exp(torch.complex(d.real, d.imag + phase)))
            dens.append(torch.exp(torch.complex(torch.zeros_like(phase), phase)))
    z = torch.stack(zs)  # (4, K)
    w = torch.exp(z - z.max(0, keepdim=True).values)
    wsum = w.sum(0)
    num = sum(w[i] * o for i, o in enumerate(nums)) / wsum
    den = sum(w[i] * o for i, o in enumerate(dens)) / wsum
    return num, den


def swap_base_z2(
    sampler1,
    sampler2,
    l: int,
    n_iterations: int,
    n_sweeps: int = 1,
    n_warmup: int = 100,
    n_blocks: int = 20,
):
    """-ln q_l via the swap estimator with exact Z2 (global spin-flip)
    orbit quadrature; returns (s2, err).

    Each sampled replica pair (s1, s2) is Rao-Blackwellized over its
    4-element orbit {+-s1} x {+-s2}: the per-pair estimate is

        f = sum_ab w_ab O_ab / sum_ab w_ab,
        w_ab = |psi(a s1) psi(b s2)|^2,   O_ab = swap observable at (a s1, b s2)

    which is EXACTLY unbiased for E[O] under ANY pi (the orbit-average
    identity: grouping the state sum by orbits shows E_pi[f] = E_pi[O]) -
    no Z2 symmetry of psi is assumed. Its point: for deep-ordered cat-like
    states the two Neel sectors are global-flip images of each other, so
    the quadrature restores the sector ergodicity that single-flip (and
    weakly-tempered) chains lack. Cost: 12 extra batched forwards per
    iteration (4 sign combos x (2 amplitudes + swapped pair)).

    Intended for SMALL l (the hybrid base of renyi2_increment, where the
    observable is O(1)); at large l it still has the heavy-tail bias that
    the increment chain exists to remove.
    """
    n = sampler1.n_inputs
    work = sampler1.work
    sampler1.warm_up(n_warmup)
    sampler2.warm_up(n_warmup)
    region = (torch.arange(n, device=sampler1.device) < l)[None, :]  # subsystem A = sites [0, l)

    def accum(c1, ln1, c2, ln2):
        s1, s2 = c1.spins, c2.spins
        zs, obs = [], []
        for a in (1.0, -1.0):
            for b in (1.0, -1.0):
                t1, t2 = a * s1, b * s2
                lna = engine.log_psi(work, t1) if a < 0 else ln1
                lnb = engine.log_psi(work, t2) if b < 0 else ln2
                s3 = torch.where(region, t2, t1)  # A from the other replica
                s4 = torch.where(region, t1, t2)
                zs.append(2.0 * (lna.real + lnb.real))  # ln w_ab
                obs.append(torch.exp(engine.log_psi(work, s3) + engine.log_psi(work, s4) - lna - lnb))
        z = torch.stack(zs)  # (4, K)
        w = torch.exp(z - z.max(0, keepdim=True).values)
        f = sum(w[i] * o for i, o in enumerate(obs)) / w.sum(0)  # per-walker orbit-averaged swap estimate
        return f.real.mean(), f.imag.mean()

    re, im = run_pair_estimator(sampler1, sampler2, accum, n_iterations, n_sweeps)
    val, err, _ = _blocked_jackknife(
        lambda r, i: -np.log(np.real(r + 1j * i)), (np.asarray(re), np.asarray(im)), n_blocks
    )
    return float(val), float(err)


def renyi2_increment(
    machine,
    params,
    l: int,
    n_iterations: int,
    n_sweeps: int = 1,
    n_warmup: int = 100,
    walkers_per_level: int = 512,
    key: torch.Generator | int = 0,
    chunk: int = 0,
    n_blocks: int = 20,
    level_offset: int = 0,
    init_spins=None,
    z2_quadrature: bool = False,
    n_beta: int = 1,
    mesh=None,
    device: torch.device | str = "cuda",
):
    """S2(A = [0, l)) - S2(A = [0, level_offset)) via the increment trick;
    returns (s2, err, per_level).

    ``per_level`` is an (l - level_offset, 3) array of (ln-ratio,
    ln-ratio-err, Re ratio) per increment. Error bars: blocked jackknife of
    ln(num/den) per level (levels are independent chains), summed in
    quadrature.

    ``level_offset`` > 0 starts the ratio chain at A_{level_offset}: the
    result is -ln(q_l / q_{level_offset}); the caller supplies
    -ln q_{level_offset} separately (see drivers.measure -what=renyi_inc -l0).

    ``init_spins``: optional (s1, s2) arrays of shape (K, N) or (N,) to
    start every chain from (e.g. a Neel row for ordered states).

    ``key``: a seed or a generator on `device`; it draws the random initial
    spins of both replicas and then every sweep.

    ``chunk`` > 0 bounds the iterations per host copy (the same contract as
    AmplitudeSampler.run_estimator).

    ``z2_quadrature``: Rao-Blackwellize every level's observable over the
    global-flip orbit (``_orbit_increment_observable``).

    ``n_beta`` > 1: glued PT ladder (replica-minor within each level block) -
    walkers_per_level TOTAL chains per level of which
    walkers_per_level/n_beta beta=1 chains feed the estimator.

    ``mesh``: a walker mesh to shard the levels x walkers batch over (whole
    replica groups per shard; its first device takes the place of
    ``device``); the chains are the one-device run's.
    """
    n = machine.n_inputs
    if not (0 <= level_offset < l < n):
        raise ValueError("need 0 <= level_offset < l < n")
    if n_beta > 1 and walkers_per_level % n_beta != 0:
        raise ValueError("walkers_per_level must be a multiple of n_beta")
    n_levels = l - level_offset
    k_total = n_levels * walkers_per_level
    if mesh is not None:
        check_shards(mesh, k_total, n_beta)
        device = mesh.devices[0]
    device = torch.device(device)
    rdt = machine.dtype
    g = generator_for(key, device)

    # levels-major: walker k sits at level j = offset + k // walkers_per_level,
    # sampling W_j with A_j = [0, j) and measuring the ratio q_{j+1}/q_j;
    # within a level block the n_beta replicas of a physical chain are
    # adjacent (replica-minor), so PT swap partners are w +- 1
    level = torch.arange(level_offset, l, device=device).repeat_interleave(walkers_per_level)
    mask = torch.arange(n, device=device)[None, :] < level[:, None]  # (K, N)
    inc_site = level  # increment site of level j is site j

    if init_spins is None:
        s1 = random_spins(g, k_total, n, rdt)
        s2 = random_spins(g, k_total, n, rdt)
    else:
        s1, s2 = (torch.as_tensor(s, dtype=rdt, device=device).expand(k_total, n).contiguous() for s in init_spins)

    work = machine.make_work({k: v.to(device) for k, v in params.items()})
    state = init_glued(work, s1, s2, mask, g)
    if mesh is not None:
        state, mask, inc_site = shard_walker_tree((state, mask, inc_site), mesh, k_total)
    schedule = np.arange(n)

    state = glued_sweeps(work, state, schedule, mask, n_warmup, n_beta)
    kb_per_level = walkers_per_level // n_beta

    def b1(x):
        return x[::n_beta].contiguous()

    mask_o, inc_o = shard_map(lambda m, i: (b1(m), b1(i)), mask, inc_site)

    def observe(w, st, m_o, i_o):
        """The per-walker (num, den) of one shard (or of all walkers)."""
        if n_beta > 1:
            # beta=1 readout slice (replica-minor): the hot replicas are
            # auxiliary; observables (incl. the z2q orbit forwards) are
            # only evaluated on the cold chains
            st = GluedState(*(Cache(*map(b1, c)) for c in st[:4]), *map(b1, st[4:8]), *st[8:])
        if z2_quadrature:
            return _orbit_increment_observable(w, st, m_o, i_o)
        return _increment_observable(w, st, i_o)

    def step():
        nonlocal state
        state = glued_sweeps(work, state, schedule, mask, n_sweeps, n_beta)
        num, den = gather(shard_map(observe, work, state, mask_o, inc_o))

        # per-level means over the readout-walker axis
        def per(x):
            return x.reshape(n_levels, kb_per_level).mean(1)

        return per(num.real), per(num.imag), per(den.real), per(den.imag)

    nr, ni, dr, di = run_chunked(step, n_iterations, chunk)  # (T, n_levels) each

    def ln_ratio(a, b, c, d):
        return np.log(np.real((a + 1j * b) / (c + 1j * d)))

    per_level = np.zeros((n_levels, 3))
    for j in range(n_levels):
        v, e, _ = _blocked_jackknife(ln_ratio, (nr[:, j], ni[:, j], dr[:, j], di[:, j]), n_blocks)
        r = np.real((nr[:, j].mean() + 1j * ni[:, j].mean()) / (dr[:, j].mean() + 1j * di[:, j].mean()))
        per_level[j] = (v, e, r)

    s2 = float(-per_level[:, 0].sum())
    err = float(np.sqrt((per_level[:, 1] ** 2).sum()))
    return s2, err, per_level
