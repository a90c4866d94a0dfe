"""Fused single-flip Metropolis sweeps, with replica exchange: CUDA kernel
and plain version.

``metropolis_sweeps`` runs ``n_steps = uniforms.shape[0]`` proposal rounds,
round t flipping site ``schedule[t % n_sites]`` in every walker and
accepting where ``uniforms[t] < exp(2 beta min(Re dln, 0))``. With
``n_beta > 1`` the walkers are replica-minor (row w = chain * n_beta + r
holds beta_r = (n_beta - r) / n_beta, ``replica_betas``), n_steps is a
whole number of sweeps of n_sites rounds, and each sweep is followed by the
even-pair and then the odd-pair swap phase (``swap_phase``) on the caller's
(n_sweeps, 2, K) swap uniforms. A CUDA tensor goes to the kernel in
``csrc/sweep.cu`` (float32) or its float64 instances in
``csrc/sweep_f64.cu``; a CPU tensor goes to ``sweep_plain``, the same
computation in PyTorch. The uniforms are either
tensors drawn by the caller or a ``rng.PhiloxDraws`` (a key): the kernel
then draws them on the chip and the plain version makes the same
numbers with ``rng.philox_uniforms``. Either way both take the same uniforms,
so they make the same decisions. The sampler gives the kernel a whole
call's rounds at once (``sampler/metropolis.py::sweep_calls``), as the JAX
package's ``pallas_sweeps`` runs a call in one ``pallas_call``. The kernel has an
instance for the RBM family (c = 1) and one for the FFNN family's complex
output weights ``work.c``, each at n_beta = 1 and for n_beta > 1; a machine
without a visible bias gets zeros.

Replaces ``neural_network_quantum_state_tpu/ops/pallas_sweep.py``; the
plain tempered rounds and swap phase are the JAX package's
``sampler/tempering.py::_tempered_flip_scan`` and ``_swap_phase``.
"""

from __future__ import annotations

import ctypes

import torch

from neural_network_quantum_state_tpu_torch.ops import build, engine
from neural_network_quantum_state_tpu_torch.ops.engine import Cache, Work
from neural_network_quantum_state_tpu_torch.ops.rng import PhiloxDraws

# The kernel's blocks hold whole replica groups of at most 16 warps.
MAX_NBETA = 16
# The kernel counts rounds in an int and takes word 0 of a round's Philox
# counter as t / 4, so one launch takes fewer than 2^31 rounds (a sampler
# call of 500 sweeps of 81 sites is 40 500).
MAX_ROUNDS = 2**31 - 1


def replica_betas(n_beta: int, kb: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(K,) per-walker beta: beta_r = (n_beta - r)/n_beta, replica-minor
    (w = k * n_beta + r)."""
    r = torch.arange(n_beta, dtype=dtype, device=device)
    return ((n_beta - r) / n_beta).repeat(kb)


def tempered_flip_rounds(work: Work, cache: Cache, lnpsi: torch.Tensor, sites, uniforms: torch.Tensor, beta):
    """One single-flip round per entry of `sites`, accepting where
    ``uniforms[t] < exp(2 beta min(dln, 0))`` (beta a (K,) tensor, or 1.0);
    returns (cache, lnpsi, accepted flips per walker row (K,) float64)."""
    n_acc = torch.zeros(lnpsi.shape[0], dtype=torch.float64, device=lnpsi.device)
    for t, site in enumerate(sites):
        lnpsi1 = engine.flip_log_psi(work, cache, site)
        dln = lnpsi1.real - lnpsi.real
        accept = uniforms[t] < torch.exp(2.0 * beta * torch.clamp(dln, max=0.0))
        cache = engine.commit_flip(work, cache, site, accept)
        lnpsi = torch.where(accept, lnpsi1, lnpsi)
        n_acc = n_acc + accept
    return cache, lnpsi, n_acc


def swap_phase(cache: Cache, lnpsi: torch.Tensor, u: torch.Tensor, parity: int, n_beta: int):
    """One swap phase: pairs of rows (r, r+1) with r = parity mod 2, accept
    where ``u[lower] < exp(2 (1/n_beta) min(Re ln_upper - Re ln_lower, 0))``,
    both members exchanged by a partner gather. Returns (cache, lnpsi,
    acc_lower): the (K,) bool mask of accepted lower pair members."""
    k = lnpsi.shape[0]
    idx = torch.arange(k, device=lnpsi.device)
    r = idx % n_beta
    in_lower = ((r - parity) % 2 == 0) & (r >= parity) & (r + 1 < n_beta)
    in_upper = ((r - parity) % 2 == 1) & (r > parity)
    partner = torch.where(in_lower, idx + 1, torch.where(in_upper, idx - 1, idx))
    dbeta = 1.0 / n_beta
    dln = lnpsi.real[partner] - lnpsi.real  # for lower rows: upper - lower
    acc_lower = in_lower & (u < torch.exp(2.0 * dbeta * torch.clamp(dln, max=0.0)))
    acc = acc_lower | acc_lower[partner]  # the upper member mirrors its lower

    def gather(x):
        return torch.where(acc.reshape((-1,) + (1,) * (x.dim() - 1)), x[partner], x)

    return Cache(*map(gather, cache)), gather(lnpsi), acc_lower


def n_rounds(uniforms) -> int:
    """The proposal rounds of a call: rows of the uniforms tensor, or of the
    Philox draws."""
    return uniforms.n_rounds if isinstance(uniforms, PhiloxDraws) else uniforms.shape[0]


def check_ladder(what: str, k: int, n_steps: int, sweep_len: int, n_beta: int, swap_uniforms,
                 philox: bool = False) -> int:
    """Validate a call's replica layout; returns the number of sweeps (of
    ``sweep_len`` rounds; one for n_beta = 1). With Philox draws the swap
    uniforms come from the same stream, so the caller passes none. ``what``
    names the caller in the errors (the sweep, the exchange)."""
    if n_beta < 1 or k % n_beta != 0:
        raise ValueError(f"{what}: n_walkers ({k}) must be a multiple of n_beta ({n_beta})")
    if philox and swap_uniforms is not None:
        raise ValueError(f"{what}: with Philox draws the swap uniforms come from the stream; pass none")
    if n_beta == 1:
        return 1
    if n_steps % sweep_len != 0:
        raise ValueError(f"{what}: with n_beta > 1 the rounds ({n_steps}) must be whole sweeps of {sweep_len}")
    n_sweeps = n_steps // sweep_len
    if philox:
        return n_sweeps
    if swap_uniforms is None or tuple(swap_uniforms.shape) != (n_sweeps, 2, k):
        got = None if swap_uniforms is None else tuple(swap_uniforms.shape)
        raise ValueError(f"{what}: n_beta > 1 needs swap uniforms of shape {(n_sweeps, 2, k)}, got {got}")
    return n_sweeps


def sweep_plain(work: Work, cache: Cache, lnpsi: torch.Tensor, schedule, uniforms,
                n_beta: int = 1, swap_uniforms: torch.Tensor | None = None, rows: bool = False):
    """Plain PyTorch sweeps; returns (cache, lnpsi, n_accepted).

    ``uniforms`` is the (n_steps, K) flip block or a ``PhiloxDraws``, whose
    flip and swap uniforms are made here. With ``rows=True`` the third item
    is a (2, K) float64 tensor instead: the accepted flips of each walker row
    and the accepted swaps with each row as the lower member.
    """
    sweep_plain.calls += 1
    sites = [int(s) for s in torch.as_tensor(schedule).tolist()]
    k, n_steps = lnpsi.shape[0], n_rounds(uniforms)
    philox = isinstance(uniforms, PhiloxDraws)
    n_sweeps = check_ladder("sweep", k, n_steps, len(sites), n_beta, swap_uniforms, philox)
    if philox:
        uniforms, swap_uniforms = uniforms.flips(k), uniforms.swaps(n_sweeps, k) if n_beta > 1 else None
    rounds = n_steps // n_sweeps
    beta = replica_betas(n_beta, k // n_beta, cache.spins.dtype, cache.spins.device) if n_beta > 1 else 1.0
    stats = torch.zeros((2, k), dtype=torch.float64, device=lnpsi.device)
    for s in range(n_sweeps):
        span = range(s * rounds, (s + 1) * rounds)
        cache, lnpsi, n_acc = tempered_flip_rounds(
            work, cache, lnpsi, [sites[t % len(sites)] for t in span], uniforms[span.start:span.stop], beta
        )
        stats[0] += n_acc
        if n_beta > 1:
            for parity in (0, 1):
                cache, lnpsi, acc_lower = swap_phase(cache, lnpsi, swap_uniforms[s, parity], parity, n_beta)
                stats[1] += acc_lower
    return cache, lnpsi, stats if rows else stats[0].sum()


sweep_plain.calls = 0


def _kernel(name: str, symbol: str, n_pointers: int, n_tables: int = 0):
    """The C launch function: pointers, six ints, the stream, one int (the
    sweep's sources: the Philox counter's row offset ``row0``; the
    megakernel: its table's range class), then ``n_tables`` pointers (the
    float64 instances' table)."""
    fn = getattr(build.library(name), symbol)
    fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * n_tables)
    fn.restype = ctypes.c_int
    return fn


def launch_sweeps(kernel: str, work: Work, cache: Cache, schedule, uniforms, n_beta: int,
                  swap_uniforms: torch.Tensor | None, extra: tuple = ()):
    """Check the inputs, allocate the outputs and launch ``kernel`` (the
    sweep kernel, or the fused sweep + energy kernel with its table and its
    extra output pointers); returns (cache, stats (2, K) int32). ``uniforms`` is
    the (n_steps, K) flip block or a ``PhiloxDraws``. The sweep takes float32
    and float64 walkers (``csrc/sweep_f64.cu``; caller uniforms in float64
    too), the megakernel float32 only, as the JAX package's."""
    k, n = cache.spins.shape
    h = work.w.shape[1]
    dev = cache.spins.device
    f64 = kernel == "sweep" and cache.spins.dtype == torch.float64
    if cache.spins.dtype != torch.float32 and not f64:
        ported = "float32 and float64 are" if kernel == "sweep" else "only float32 is"
        raise NotImplementedError(f"{kernel} kernel: {ported} ported, got {cache.spins.dtype}")
    rdt, cdt = (torch.float64, torch.complex128) if f64 else (torch.float32, torch.complex64)
    if n_beta > MAX_NBETA:
        raise ValueError(f"{kernel} kernel: n_beta={n_beta} above the in-kernel ladder's limit of {MAX_NBETA}")
    sched = torch.as_tensor(schedule, dtype=torch.int32, device=dev)
    n_steps = n_rounds(uniforms)
    if not 0 < n_steps <= MAX_ROUNDS:
        raise ValueError(f"{kernel} kernel: {n_steps} proposal rounds, not in [1, {MAX_ROUNDS}]")
    philox = isinstance(uniforms, PhiloxDraws)
    n_sweeps = check_ladder(kernel, k, n_steps, sched.shape[0], n_beta, swap_uniforms, philox)
    tensors, weights = engine.kernel_weights(work, cdt)
    tensors |= {
        "spins": (cache.spins, rdt, (k, n)),
        "y": (cache.y, cdt, (k, h)),
        "sa": (cache.sa, cdt, (k,)),
    }
    row0 = uniforms.row0 if philox else 0
    if row0 and kernel != "sweep":
        raise ValueError(f"{kernel} kernel: takes no row offset (row0={row0})")
    if philox:
        tensors["key"] = (uniforms.key, torch.int64, (2,))
        u_ptr, swap_ptr, key_ptr = None, None, uniforms.key.data_ptr()
    else:
        tensors["uniforms"] = (uniforms, rdt, (n_steps, k))
        if n_beta > 1:
            tensors["swap_uniforms"] = (swap_uniforms, rdt, (n_sweeps, 2, k))
        u_ptr, key_ptr = uniforms.data_ptr(), None
        swap_ptr = swap_uniforms.data_ptr() if n_beta > 1 else None
    build.check_inputs(kernel, dev, h, tensors, row0, k)
    spins = torch.empty_like(cache.spins)
    y = torch.empty_like(cache.y)
    sa = torch.empty_like(cache.sa)
    stats = torch.empty((2, k), dtype=torch.int32, device=dev)
    symbol = {"sweep": "nqs_sweep_f32", "sweep_energy": "nqs_sweep_offdiag_f32"}[kernel]
    pointers, after_row0, tail = list(weights), (), row0
    if f64:  # its own source; its table of e^{4 s w} and per-site terms (range checked) after row0
        kernel, symbol = "sweep_f64", "nqs_sweep_f64"
        g, a_site = engine.sweep_table_f64(work)
        after_row0 = (g.data_ptr(), a_site.data_ptr())
    elif kernel == "sweep":  # its instances with c read the energy kernel's table (rbm.cuh sweep_walker)
        table = engine.kernel_table(work.w) if work.c is not None else None
        pointers.append(None if table is None else table.data_ptr())
    else:  # the megakernel: its table (range checked) before out, its range class in place of row0
        g, site, narrow = engine.sweep_table_f32(work)
        extra, tail = (g, site, *extra), int(narrow)
    rc = build.launch(
        dev, _kernel(kernel, symbol, 12 + len(pointers) + len(extra), len(after_row0)),
        *pointers, cache.spins.data_ptr(), cache.y.data_ptr(), cache.sa.data_ptr(),
        sched.data_ptr(), u_ptr, swap_ptr, key_ptr,
        spins.data_ptr(), y.data_ptr(), sa.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
        *(t.data_ptr() for t in extra), k, n, h, sched.shape[0], n_steps, n_beta,
        torch.cuda.current_stream(dev).cuda_stream, tail, *after_row0,
    )
    build.check_launch(rc, f"{kernel} kernel")
    return Cache(spins=spins, y=y, sa=sa), stats


def sweep_cuda(work: Work, cache: Cache, schedule, uniforms, n_beta: int = 1,
               swap_uniforms: torch.Tensor | None = None, rows: bool = False):
    """Launch the sweep kernel's instance for the walkers' dtype: float32
    (counted in ``launches``) or float64 (``csrc/sweep_f64.cu``, counted in
    ``launches_f64``); returns (cache, lnpsi, n_accepted), or with
    ``rows=True`` the (2, K) per-row counts of ``sweep_plain``.

    The complex ln psi of the final states is recomputed from the final
    cache with the plain log-cosh, as every later consumer mixes it with
    ln psi values computed by that log-cosh.
    """
    f64 = cache.spins.dtype == torch.float64
    cache, stats = launch_sweeps("sweep", work, cache, schedule, uniforms, n_beta, swap_uniforms)
    if f64:
        sweep_cuda.launches_f64 += 1
    else:
        sweep_cuda.launches += 1
    lnpsi = engine.cache_log_psi(work, cache)
    return cache, lnpsi, stats.to(torch.float64) if rows else stats[0].sum(dtype=torch.float64)


sweep_cuda.launches = 0
sweep_cuda.launches_f64 = 0


def metropolis_sweeps(work: Work, cache: Cache, lnpsi: torch.Tensor, schedule, uniforms,
                      n_beta: int = 1, swap_uniforms: torch.Tensor | None = None, rows: bool = False):
    """Run ``n_rounds(uniforms)`` proposal rounds (and for n_beta > 1 the
    swap phases after each sweep); returns (cache, lnpsi, n_accepted).

    The kernel on a CUDA tensor (or an error), the plain version on a CPU one.
    """
    if cache.spins.device.type == "cpu":
        return sweep_plain(work, cache, lnpsi, schedule, uniforms, n_beta, swap_uniforms, rows)
    return sweep_cuda(work, cache, schedule, uniforms, n_beta, swap_uniforms, rows)
