"""Measurement estimators (reference L7; the JAX package's
``measurements/estimators.py``).

Ports of cpu/include/measurements.hpp:13-483 and gpu/include/meas.cuh:11-283
(+impl_meas.cuh). Conventions (means over chains x iterations, error bars,
conjugations) follow the reference exactly; citations on each function.

Execution model: every estimator's iteration loop is
``AmplitudeSampler.run_estimator`` / ``run_pair_estimator``: one sampler
call per iteration (on the card one sweep-kernel launch), then the
estimator's per-iteration body in PyTorch on the beta = 1 slice, its
outputs kept on the device and copied back once per chunk. Statistics and
error bars are computed on the host exactly as the reference does. Native
complex tensors carry ln psi and the complex ratios.
"""

from __future__ import annotations

import numpy as np
import torch

from neural_network_quantum_state_tpu_torch.measurements.sampler import AmplitudeSampler, run_pair_estimator
from neural_network_quantum_state_tpu_torch.ops import engine


def _complex_coeff(z, n: int, sampler: AmplitudeSampler) -> torch.Tensor:
    """Order-parameter coefficients (N,) as a complex tensor of the machine's
    precision on the sampler's device (ones for None)."""
    cdt = sampler.machine.complex_dtype
    if z is None:
        return torch.ones(n, dtype=cdt, device=sampler.device)
    if isinstance(z, torch.Tensor):
        return z.to(device=sampler.device, dtype=cdt)
    return torch.as_tensor(np.asarray(z, dtype=np.complex128), device=sampler.device).to(cdt)


# ---------------------------------------------------------------------------
def measure_energy(vmc_or_pair, n_trials: int, n_sweeps: int = 1):
    """<Etilde> over n_trials sampling rounds, mean +/- std-of-trial-means
    (free fn meas_energy, cpu measurements.hpp:123-144).

    Accepts an (AmplitudeSampler, hamiltonian) tuple (or a
    FermionAmplitudeSampler with the Hubbard chain).
    """
    sampler, ham = vmc_or_pair
    work = sampler.work

    def accum(cache, lnpsi):
        ht = ham.local_energy(work, cache, lnpsi)
        return ht.real.mean(), ht.imag.mean()

    re, im = sampler.run_estimator(accum, n_trials, n_sweeps)
    means = np.asarray(re) + 1j * np.asarray(im)
    err = means.real.std(ddof=1) / np.sqrt(n_trials) if n_trials > 1 else 0.0
    return means.mean(), err


# ---------------------------------------------------------------------------
def _abs_mag_moments(sampler: AmplitudeSampler, coeff, n_iterations, n_sweeps, n_warmup,
                     return_trials: bool = False):
    """Shared core of MeasSpontaneousMagnetization / MeasOrderParameter
    (impl_meas.cuh:418-505): m = |(1/N) sum_i coeff_i s_i| per walker;
    returns (m1, m2, m4) = (<m>, <m^2>, <m^4>).

    return_trials=True instead returns the per-iteration (n_iterations,)
    moment arrays, for blocked/jackknife error estimation of derived
    quantities (Binder cumulant error bars - see binder_cumulant)."""
    sampler.warm_up(n_warmup)
    n = sampler.n_inputs
    co = _complex_coeff(coeff, n, sampler)

    def accum(cache, lnpsi):
        spins = cache.spins
        m = torch.complex(spins @ co.real, spins @ co.imag) * (1.0 / n)
        mag = m.abs()
        return mag.mean(), (mag**2).mean(), (mag**4).mean()

    m1, m2, m4 = sampler.run_estimator(accum, n_iterations, n_sweeps)
    if return_trials:
        return np.asarray(m1), np.asarray(m2), np.asarray(m4)
    return float(np.mean(m1)), float(np.mean(m2)), float(np.mean(m4))


def _blocked_jackknife(fn, trials, n_blocks: int = 20):
    """Blocked jackknife of a nonlinear statistic ``fn(*means)``.

    Per-iteration estimates are autocorrelated (successive estimates are
    n_sweeps apart); blocking into n_blocks bins decorrelates them, and
    the leave-one-block-out jackknife propagates the nonlinearity
    correctly (a naive per-trial average of fn is biased). ``fn`` is
    evaluated on scalars for the central value and broadcast over the
    leave-one-out arrays for the error.

    Returns (value, err, block_means). Needs >= 2 trials (with one the
    blocking degenerates to an empty array and everything becomes NaN)."""
    ts = [np.asarray(t, np.float64) for t in trials]
    size = ts[0].size
    if size < 2:
        raise ValueError(f"blocked jackknife needs >= 2 trial estimates, got {size}")
    n_blocks = max(2, min(n_blocks, size))
    usable = (size // n_blocks) * n_blocks
    bs = [t[:usable].reshape(n_blocks, -1).mean(axis=1) for t in ts]
    value = fn(*[b.mean() for b in bs])
    jk = fn(*[(b.sum() - b) / (n_blocks - 1) for b in bs])
    err = np.sqrt((n_blocks - 1) / n_blocks * ((jk - jk.mean()) ** 2).sum())
    return float(value), float(err), bs


def binder_cumulant(m2_trials: np.ndarray, m4_trials: np.ndarray, n_blocks: int = 20):
    """U = 1 - <m^4>/(3 <m^2>^2) with a blocked-jackknife error.

    Standard FSS methodology for locating the crossing (the reference
    paper's analysis; python/meas_smag.py:32-41 computes U without error
    bars)."""
    u, u_err, _ = _blocked_jackknife(
        lambda m2, m4: 1.0 - m4 / (3.0 * m2**2), (m2_trials, m4_trials), n_blocks
    )
    return u, u_err


def spontaneous_magnetization(sampler: AmplitudeSampler, n_iterations: int, n_sweeps: int = 1, n_warmup: int = 100,
                              return_trials: bool = False):
    """m1=<|m|>, m2=<m^2>, m4=<m^4> (MeasSpontaneousMagnetization,
    gpu meas.cuh:182-198, cpu measurements.hpp:153-249)."""
    return _abs_mag_moments(sampler, None, n_iterations, n_sweeps, n_warmup, return_trials)


def order_parameter(sampler: AmplitudeSampler, coeff, n_iterations: int, n_sweeps: int = 1, n_warmup: int = 100,
                    return_trials: bool = False):
    """Generic coefficient-weighted magnetization moments (MeasOrderParameter,
    gpu meas.cuh:202-219)."""
    return _abs_mag_moments(sampler, coeff, n_iterations, n_sweeps, n_warmup, return_trials)


def neel_order(sampler: AmplitudeSampler, l: int, n_iterations: int, n_sweeps: int = 1, n_warmup: int = 100):
    """Staggered magnetization on the square lattice: coeff = (-1)^(i+j)
    (MeasNeelOrder, cpu measurements.hpp:359-482)."""
    i, j = np.meshgrid(np.arange(l), np.arange(l), indexing="ij")
    coeff = ((-1.0) ** (i + j)).ravel()
    return _abs_mag_moments(sampler, coeff, n_iterations, n_sweeps, n_warmup)


def structure_factor_trials(sampler: AmplitudeSampler, ks, n_iterations: int,
                            n_sweeps: int = 1, n_warmup: int = 100) -> np.ndarray:
    """Per-iteration estimates of the chain structure factor
    S(k) = N <|m_k|^2>, with m_k = (1/N) sum_j s_j e^{ikj}, for each wave
    number in ``ks``; returns an (n_iterations, len(ks)) array.

    All wave numbers are accumulated in ONE pass (a single (K, N) x (N, nk)
    GEMM per iteration), diagonal in the sigma_z basis like the
    magnetization moments. New capability beyond the reference measurement
    set (cpu measurements.hpp has magnetization moments and two-point
    sigma-z correlators but no momentum-space observable)."""
    sampler.warm_up(n_warmup)
    n = sampler.n_inputs
    rdt = sampler.machine.dtype
    phases = np.outer(np.asarray(ks, np.float64), np.arange(n))  # (nk, N)
    co_re = torch.as_tensor(np.cos(phases).T, dtype=rdt, device=sampler.device)  # (N, nk)
    co_im = torch.as_tensor(np.sin(phases).T, dtype=rdt, device=sampler.device)

    def accum(cache, lnpsi):
        spins = cache.spins  # (K, N)
        mre = spins @ co_re
        mim = spins @ co_im
        # S(k) = N <|m_k|^2> = (1/N) <|sum_j s_j e^{ikj}|^2>
        return (mre**2 + mim**2).mean(0) / n

    return np.asarray(sampler.run_estimator(accum, n_iterations, n_sweeps))


def correlation_ratio(sampler: AmplitudeSampler, n_iterations: int, n_sweeps: int = 1,
                      n_warmup: int = 100, n_blocks: int = 20):
    """R_N = S(pi + 2pi/N) / S(pi): the correlation-ratio crossing
    observable for the AFM chain, with a blocked-jackknife error.

    R_N -> 0 in the ordered phase (Bragg peak at the staggered wave
    vector k = pi dwarfs its neighbor) and -> 1 in the disordered phase
    (S(k) flat); like the Binder cumulant, R_N(theta) curves for
    different N cross at theta_c, giving an INDEPENDENT finite-size
    estimate from the same sampled configurations.

    Returns (r, r_err, s_peak, s_neighbor)."""
    n = sampler.n_inputs
    ks = [np.pi, np.pi + 2.0 * np.pi / n]
    s_t = structure_factor_trials(sampler, ks, n_iterations, n_sweeps, n_warmup)
    r_full, r_err, (sp_b, sn_b) = _blocked_jackknife(
        lambda sp, sn: sn / sp, (s_t[:, 0], s_t[:, 1]), n_blocks
    )
    return r_full, r_err, float(sp_b.mean()), float(sn_b.mean())


# ---------------------------------------------------------------------------
def overlap_integral(
    sampler: AmplitudeSampler,
    work2: engine.Work,
    n_trials: int,
    n_warmup: int = 100,
    n_sweeps: int = 1,
):
    """<psi1|psi2>/<psi1|psi1> ~ < exp(lnpsi2 - lnpsi1) >_{|psi1|^2}, with
    per-trial means and their stddevs (MeasOverlapIntegral,
    impl_meas.cuh:145-196; cpu measurements.hpp:13-120).
    Returns (mean complex, re_err, im_err)."""
    sampler.warm_up(n_warmup)

    def accum(cache, lnpsi):
        r = torch.exp(engine.log_psi(work2, cache.spins) - lnpsi)
        return r.real.mean(), r.imag.mean()

    re, im = sampler.run_estimator(accum, n_trials, n_sweeps)
    vals = np.asarray(re) + 1j * np.asarray(im)
    mean = vals.mean()
    re_err = vals.real.std(ddof=1) if n_trials > 1 else 0.0
    im_err = vals.imag.std(ddof=1) if n_trials > 1 else 0.0
    return mean, re_err, im_err


# ---------------------------------------------------------------------------
def renyi2_entropy(
    sampler1: AmplitudeSampler,
    sampler2: AmplitudeSampler,
    l: int,
    n_iterations: int,
    n_sweeps: int = 1,
    n_warmup: int = 100,
    return_error: bool = False,
):
    """S2 = -log Tr rho_A^2 via the swap trick on two independent replicas
    (MeasRenyiEntropy, impl_meas.cuh:57-142): swap sites [l, N) between the
    replicas and average conj(exp(ln3 + ln4 - ln1 - ln2)).

    Subsystem A = sites [0, l); both replicas sample |psi|^2.
    """
    n = sampler1.n_inputs
    if not (0 <= l < n):
        raise ValueError("l out of range")
    work = sampler1.work
    sampler1.warm_up(n_warmup)
    sampler2.warm_up(n_warmup)

    region = torch.arange(n, device=sampler1.device) >= l  # sites swapped between replicas

    def accum(c1, ln1, c2, ln2):
        s1, s2 = c1.spins, c2.spins
        s3 = torch.where(region[None, :], s2, s1)
        s4 = torch.where(region[None, :], s1, s2)
        r = torch.exp(engine.log_psi(work, s3) + engine.log_psi(work, s4) - ln1 - ln2)
        # conj then accumulate (meas__GetRho2local__): only Re survives the mean
        return r.real.mean()

    tr2 = np.asarray(run_pair_estimator(sampler1, sampler2, accum, n_iterations, n_sweeps))
    rho2 = tr2.mean()
    s2 = float(-np.log(rho2))
    if return_error:
        # error bar convention of python/meas_renyi.py:57-58:
        # err(Tr rho^2) = sqrt(sum (x - mean)^2 / (n (n-1))), propagated
        # through -log as err/mean
        if n_iterations > 1:
            err_tr2 = float(np.sqrt(np.sum((tr2 - rho2) ** 2) / (n_iterations * (n_iterations - 1))))
        else:
            err_tr2 = 0.0
        return s2, err_tr2 / max(rho2, 1e-300)
    return s2


# ---------------------------------------------------------------------------
def fidelity(
    sampler1: AmplitudeSampler,
    sampler2: AmplitudeSampler,
    n_meas: int,
    n_warmup: int = 100,
    n_sweeps: int = 1,
):
    """|<psi1|psi2>| via two-replica cross ratios (MeasFidelity,
    impl_meas.cuh:199-268): per-iteration r_n = Re mean_k of
    conj(exp(ln<s2|psi1> + ln<s1|psi2> - ln<s1|psi1> - ln<s2|psi2>));
    returns (sqrt(mean r), jackknife-style err)."""
    work1, work2 = sampler1.work, sampler2.work
    sampler1.warm_up(n_warmup)
    sampler2.warm_up(n_warmup)

    def accum(c1, ln1, c2, ln2):
        ln3 = engine.log_psi(work1, c2.spins)  # <sigma_2|psi_1>
        ln4 = engine.log_psi(work2, c1.spins)  # <sigma_1|psi_2>
        return torch.exp(ln3 + ln4 - ln1 - ln2).real.mean()

    r = np.asarray(run_pair_estimator(sampler1, sampler2, accum, n_meas, n_sweeps))
    rho_mean = float(np.sqrt(np.mean(r)))
    if n_meas > 1:
        err = float(np.sqrt(np.sum((np.sqrt(np.abs(r)) - rho_mean) ** 2) / ((n_meas - 1) * n_meas)))
    else:
        err = 0.0
    return rho_mean, err


# ---------------------------------------------------------------------------
def spin_z_correlation(sampler: AmplitudeSampler, n_iterations: int, n_sweeps: int = 1, n_warmup: int = 100):
    """<s_i s_j> matrix via walker-axis rank-K updates (herk accumulation,
    MeasSpinZSpinZCorrelation, impl_meas.cuh:271-312)."""
    sampler.warm_up(n_warmup)

    def accum(cache, lnpsi):
        spins = cache.spins
        return spins.T @ spins / spins.shape[0]

    ss = sampler.run_estimator(accum, n_iterations, n_sweeps)  # (T, N, N)
    return np.asarray(ss).mean(axis=0)


# Cap on K * chunk * H flip-tensor elements per site block - the same budget
# as ops.energy.OFFDIAG_CHUNK_ELEMS, so xx-correlations run at production
# shapes (N=128, H=512, thousands of walkers) without materializing the
# full (K, N, H) tensor.
_FLIP_CHUNK_ELEMS = 64 * 1024 * 1024


def _flip_ratio_means(work: engine.Work, cache: engine.Cache, lnpsi: torch.Tensor, n_sites: int) -> torch.Tensor:
    """mean_k Re exp(lnpsi(flip_j s_k) - lnpsi(s_k)) for every site j: (N,).

    Sites are processed in blocks sized so the (K, chunk, H) flip tensor
    stays under _FLIP_CHUNK_ELEMS elements (the single-shot tensor OOMs
    first at N=128/H=512/K=8192)."""
    k = cache.spins.shape[0]
    h = work.w.shape[1]
    chunk = max(1, min(n_sites, _FLIP_CHUNK_ELEMS // max(1, k * h)))
    dev = cache.spins.device
    out = []
    for start in range(0, n_sites, chunk):
        sites = torch.arange(start, min(n_sites, start + chunk), device=dev)
        ln1 = engine.all_flip_log_psi(work, cache, sites)  # (K, chunk)
        out.append(torch.exp(ln1 - lnpsi[:, None]).real.mean(0))
    return torch.cat(out)


def spin_x_correlation(sampler: AmplitudeSampler, n_iterations: int, n_sweeps: int = 1, n_warmup: int = 100):
    """<sigma^x_i> and <sigma^x_i sigma^x_j> via 1-flip and 2-flip amplitude
    ratios (MeasSpinXSpinXCorrelation, impl_meas.cuh:315-470; cpu
    measurements.hpp:252-356). The reference's N^2 sequential forwards
    become one batched flip tensor per row i, with the j-flip tensor
    site-chunked for production shapes (_flip_ratio_means).

    Returns (s (N,), ss (N,N)) with the diagonal of ss set to 1.
    """
    sampler.warm_up(n_warmup)
    n = sampler.n_inputs
    work = sampler.work

    def accum(cache: engine.Cache, lnpsi: torch.Tensor):
        # <sigma^x_i>: all single flips, site-chunked
        s_acc = _flip_ratio_means(work, cache, lnpsi, n)  # (N,)
        # <sigma^x_i sigma^x_j>: flip i committed, then all flips j
        every = torch.ones(cache.spins.shape[0], dtype=torch.bool, device=cache.spins.device)
        rows = [_flip_ratio_means(work, engine.commit_flip(work, cache, i, every), lnpsi, n) for i in range(n)]
        return s_acc, torch.stack(rows)  # (N,), (N, N)

    s_t, ss_t = sampler.run_estimator(accum, n_iterations, n_sweeps)
    s = np.asarray(s_t).mean(axis=0)
    ss = np.asarray(ss_t).mean(axis=0)
    np.fill_diagonal(ss, 1.0)  # sigma^x_i sigma^x_i = identity
    return s, ss
