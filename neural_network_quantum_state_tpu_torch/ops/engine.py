"""Generic batched log-cosh machine engine.

Every ansatz has the functional form

    ln psi(s) = sum_j c_j logcosh( b_j + sum_i W_ij s_i ) + sum_i a_i s_i

over effective (possibly symmetry-expanded) complex weights W (N,H), hidden
bias b (H,), visible bias a (N,) and output weights c (H,). The RBM family
has c = 1 (``Work.c`` None); the FFNN family has a = 0 (``Work.a`` None) and
trainable c; the bias-free RBMs have neither. This module evaluates that
form batched over walkers (leading axis K) with the O(H)-per-proposal
incremental update of the hidden pre-activations

    y'_kj = y_kj - 2 s_ki W_ij          (candidate: flip spin i)

Spins are real {-1,+1}; y, sa and ln psi are native complex tensors.
"""

from __future__ import annotations

import functools
import math
import threading
from typing import NamedTuple, Optional

import torch

from neural_network_quantum_state_tpu_torch.ops.logcosh import logcosh


class Work(NamedTuple):
    """Effective dense weights of a log-cosh machine (symmetry-expanded)."""

    w: torch.Tensor  # (N, H) complex
    b: torch.Tensor  # (H,) complex
    a: Optional[torch.Tensor] = None  # (N,) complex or None (no visible bias)
    c: Optional[torch.Tensor] = None  # (H,) complex or None (c_j = 1)


@functools.lru_cache(maxsize=None)
def _zero_bias(n: int, device: torch.device, dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    return torch.zeros(n, dtype=dtype, device=device)


def kernel_weights(work: Work, dtype: torch.dtype = torch.complex64) -> tuple[dict, tuple]:
    """What the CUDA kernels read of `work`: the ``build.check_inputs``
    entries of w, a and c in the complex ``dtype`` of the kernel instance,
    and the pointers (w, a, c) in the kernels' argument order.

    A machine without a visible bias (``a`` None) gets zeros for a, made
    once per size, device and dtype, as the JAX package's kernels feed;
    without output weights (``c`` None, c = 1: the RBM family) the c pointer
    is None and the kernels' instance without c runs.
    """
    n, h = work.w.shape
    a = work.a if work.a is not None else _zero_bias(n, work.w.device, dtype)
    entries = {"w": (work.w, dtype, (n, h)), "a": (a, dtype, (n,))}
    if work.c is not None:
        entries["c"] = (work.c, dtype, (h,))
    c_ptr = None if work.c is None else work.c.data_ptr()
    return entries, (work.w.data_ptr(), a.data_ptr(), c_ptr)


# This thread's memos of the kernels' inputs, by name: device -> (the key
# tensors with their version counters, the value, the key's other parts).
# Thread-local, so that the concurrent grid points of drivers/train.py
# -gridmesh keep their own tables on one card instead of replacing each
# other's on every launch.
_memos = threading.local()


def memo(name: str) -> dict:
    """This thread's memo ``name``: device -> its last entry."""
    entries = getattr(_memos, name, None)
    if entries is None:
        entries = {}
        setattr(_memos, name, entries)
    return entries


def memoised(name: str, tensors: tuple, build, *extra):
    """``build()`` of the tensors (some None, the first one not) and the
    hashable ``extra``, kept per device and thread in ``memo(name)`` with the
    tensors and their version counters: the same tensors, not updated in
    place since, with an equal ``extra`` return the kept value; anything
    else builds anew and replaces it."""
    entries = memo(name)
    key = tuple((t, None if t is None else t._version) for t in tensors)
    device = tensors[0].device
    last = entries.get(device)
    if (last is not None and last[2] == extra
            and all(a is b and va == vb for (a, va), (b, vb) in zip(last[0], key))):
        return last[1]
    value = build()
    entries[device] = (key, value, extra)
    return value


def kernel_table(w: torch.Tensor) -> torch.Tensor:
    """(N, H, 4) real (Re w, Im w, cos 2 Im w, sin 2 Im w) of complex w, in
    w's real dtype: the weights as the energy kernel's float32 instances and
    the sweep's instances with c read them, one 16-byte load
    per (site, hidden unit) (the float64 instance reads ``kernel_table_f64``).
    The kernels take a flipped unit's cos/sin(Im y - 2 s Im w) by angle
    addition from cos/sin(2 Im w), as the JAX energy kernel's XLA caller
    tabulates them (``pallas_energy.py``'s c2w/s2w).

    Built once per weight tensor (``memoised``): each thread keeps the last
    table on w's device with its w and w's version counter, so the sweeps
    of one ``Work`` share one build, the shards of a mesh on other devices
    and concurrent grid points keep theirs, and a new w, or an in-place
    update of this one, makes a new table.
    """
    def build():
        two = 2.0 * w.imag
        return torch.stack((w.real, w.imag, torch.cos(two), torch.sin(two)), dim=-1)

    return memoised("kernel_table", (w,), build)


# The float64 energy instance's tiles: sites of a pass, hidden units of a tile
# (csrc/energy.cu, namespace f64).
F64_TILE_SITES, F64_TILE_UNITS = 64, 32


def kernel_table_f64(work: Work) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What the energy kernel's float64 instance reads of `work` (complex128):
    a flat float64 table and the per-site term a' in two parts.

    The table holds e^{4 s w_ij} for s = +1 and -1 in tiles of
    ``F64_TILE_SITES`` sites by ``F64_TILE_UNITS`` hidden units, ordered
    [site pass][unit tile][s][unit][site] as (re, im) pairs, w zero-padded to
    whole tiles; with output weights c, Im w follows in the same tiles
    ([site pass][unit tile][unit][site]). a' is ``_site_term``: a_i +
    sum_j w_ij for the RBM family (c None), a_i + sum_j c_j Re w_ij with c,
    and after it the rounding error of its last addition (``_site_term_lo``),
    which the kernel adds once the large parts of its exponent have
    cancelled. Built on every call (the float64 path widens the weights anew
    each step, so nothing would reuse it) and apart from ``kernel_table``'s
    memo, which float64 energy calls leave as it is.
    """
    w = work.w
    n, h = w.shape
    n_pass, n_tile = -(-n // F64_TILE_SITES), -(-h // F64_TILE_UNITS)
    wp = torch.zeros(n_pass * F64_TILE_SITES, n_tile * F64_TILE_UNITS, dtype=w.dtype, device=w.device)
    wp[:n, :h] = w

    def tiles(x: torch.Tensor) -> torch.Tensor:  # (sites, units) -> (pass, tile, unit, site)
        return x.reshape(n_pass, F64_TILE_SITES, n_tile, F64_TILE_UNITS).permute(0, 2, 3, 1)

    g = torch.stack((tiles(torch.exp(4.0 * wp)), tiles(torch.exp(-4.0 * wp))), dim=2)
    parts = [torch.view_as_real(g).reshape(-1)]
    if work.c is not None:
        parts.append(tiles(wp.imag).reshape(-1))
    hi, lo = _site_term_lo(work)
    return torch.cat(parts), hi, lo


def _site_term(work: Work) -> torch.Tensor:
    """(N,) a_i + sum_j w_ij (c None), or a_i + sum_j c_j Re w_ij (a = 0
    without a visible bias): the per-site factors e^{-2 s w_ij} of the
    float64 kernels' ratios, summed: the ``hi`` of ``_site_term_lo``."""
    w = work.w
    s = w.sum(1) if work.c is None else w.real.to(w.dtype) @ work.c
    return (s if work.a is None else work.a + s).contiguous()


def _site_term_lo(work: Work) -> tuple[torch.Tensor, torch.Tensor]:
    """``_site_term`` as (hi, lo), lo the exact rounding error of its
    addition a + s (Knuth's two-sum, per part), so that hi + lo carries
    a_i + s_i to the rounding of s_i alone: where |a'| is large (|Re w| = 25
    at every unit of a site puts it near 6400), e^{-2 s a'} would otherwise
    err by 2 |a'| 2^-53 relative."""
    w = work.w
    a = work.a if work.a is not None else torch.zeros(w.shape[0], dtype=w.dtype, device=w.device)
    s = w.sum(1) if work.c is None else w.real.to(w.dtype) @ work.c
    hi = a + s
    bb = hi - a
    return hi.contiguous(), ((a - (hi - bb)) + (s - bb)).contiguous()


# The float64 kernels' range (csrc/sweep_f64.cu, exchange_f64.cu, energy.cu's
# float64 instance): their products of factors c + u e^{4 s w} stay inside
# the double range for every |Re w| up to this, and check_f64_range refuses
# weights past it before any of them launches.
F64_MAX_RE_W = 43.0


def _check_range(w: torch.Tensor, limit: float, memo_name: str, what: str, why: str) -> float:
    """Raise ``ValueError`` where |Re w| passes ``limit`` (one host sync),
    once per weight tensor: this thread keeps the last weights that passed
    on each device, with their version counter (``memoised``). Returns the
    largest |Re w|."""

    def check():
        amax = float(w.real.abs().amax()) if w.numel() else 0.0
        if amax > limit:
            raise ValueError(f"{what}: |Re w| above {limit}, where {why}")
        return amax

    return memoised(memo_name, (w,), check)


def check_f64_range(w: torch.Tensor, what: str = "float64 kernels") -> None:
    """Raise ``ValueError`` where |Re w| passes ``F64_MAX_RE_W``, the range
    of the float64 kernels' products, once per weight tensor."""
    _check_range(w, F64_MAX_RE_W, "f64_range", what,
                 "the float64 kernels' products of factors |c + u e^(4 s w)|^2 leave the double range")


# The float32 factor-form megakernel's range (csrc/sweep_energy.cu): its table
# e^{4 s w} stays inside the float32 range (e^80 < 2^127) for every |Re w|
# up to F32_MAX_RE_W, and check_f32_range refuses weights past it before it
# launches; up to F32_PAIR_RE_W two factors |c + u e^{4 s w}|^2 multiply
# inside the float32 range, and the kernel takes its factors in pairs.
F32_MAX_RE_W, F32_PAIR_RE_W = 20.0, 5.0


def check_f32_range(w: torch.Tensor, what: str = "float32 factor-form kernel") -> float:
    """Raise ``ValueError`` where |Re w| passes ``F32_MAX_RE_W``, the range
    of the float32 table e^{4 s w}, once per weight tensor; returns the
    largest |Re w|."""
    return _check_range(w, F32_MAX_RE_W, "f32_range", what, "the float32 table e^(4 s w) leaves the float32 range")


def sweep_table_f32(work: Work) -> tuple[torch.Tensor, torch.Tensor, bool]:
    """What the megakernel (``csrc/sweep_energy.cu``) reads of `work`
    (complex64, c None) besides w and a: G (N, 2, H) complex64, e^{4 s w_ij}
    for s = +1 (``[:, 0]``) and s = -1 (``[:, 1]``), the table of both its
    phases; the per-site factors (N, 2, 4) float32 (Re m, Im m, |m|^2, k)
    with e^{-2 s (a_i + sum_j w_ij)} = m 2^k, |m| in [2^-1/2, 2^1/2], k an
    integer, for the same two signs; and whether every |Re w| is at most
    ``F32_PAIR_RE_W`` (the kernel then takes its factors in pairs, each pair
    with its power of two, else each factor with its own). The tables are
    computed in float64 from w and a and rounded once. Checks the weights'
    range first (``check_f32_range``), and builds all three once per (w, a)
    (``memoised``), as ``sweep_table_f64`` does."""
    w = work.w

    def build():
        narrow = check_f32_range(w) <= F32_PAIR_RE_W
        wd = w.to(torch.complex128)
        g = torch.stack((torch.exp(4.0 * wd), torch.exp(-4.0 * wd)), dim=1).to(torch.complex64)
        a = _site_term(Work(wd, work.b, None if work.a is None else work.a.to(torch.complex128)))
        z = torch.stack((-2.0 * a, 2.0 * a), dim=1)  # (N, 2): -2 s a' for s = +1, -1
        k = torch.round(z.real / math.log(2.0))
        m = torch.exp(torch.complex(z.real - k * math.log(2.0), z.imag))
        site = torch.stack((m.real, m.imag, m.real * m.real + m.imag * m.imag, k), dim=-1)
        return g.contiguous(), site.to(torch.float32).contiguous(), narrow

    return memoised("sweep_table_f32", (w, work.a), build)


def sweep_table_f64(work: Work) -> tuple[torch.Tensor, torch.Tensor]:
    """What the sweep kernel's float64 instances read of `work` (complex128)
    besides w, a and c: G (N, 2, H) complex, e^{4 s w_ij} for s = +1
    (``[:, 0]``) and s = -1 (``[:, 1]``), so that a warp's lanes read one
    site's row of one sign on consecutive hidden units; and the per-site
    term a' of ``kernel_table_f64``. Checks the weights' range first
    (``check_f64_range``), and builds both once per (w, a, c)
    (``memoised``), so the calls of one ``Work`` (a warm-up's chunks, a
    measurement's iterations) share one build and one range check."""
    w = work.w

    def build():
        check_f64_range(w)
        return torch.stack((torch.exp(4.0 * w), torch.exp(-4.0 * w)), dim=1), _site_term(work)

    return memoised("sweep_table_f64", (w, work.a, work.c), build)


def exchange_table_f64(work: Work, bonds: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """What the exchange kernel's float64 instances read of `work`
    (complex128) and the (B, 2) `bonds` besides w, a and c: E (B, 2, H)
    complex, e^{4 s (w_ij - w_kj)} of each bond (i, k) for s = s_i = +1
    (``[:, 0]``) and -1 (``[:, 1]``), one row per proposal for a walker's
    lanes to read on consecutive hidden units; and the per-site term a' of
    ``kernel_table_f64``. Checks the weights' range first
    (``check_f64_range``), and builds both once per (w, a, c, bonds), as
    ``sweep_table_f64`` does."""
    w = work.w

    def build():
        check_f64_range(w)
        ends = bonds.to(device=w.device, dtype=torch.long)
        d = w[ends[:, 0]] - w[ends[:, 1]]
        return torch.stack((torch.exp(4.0 * d), torch.exp(-4.0 * d)), dim=1), _site_term(work)

    return memoised("exchange_table_f64", (w, work.a, work.c, bonds), build)


class Cache(NamedTuple):
    """Per-walker machine state threaded through the sampler."""

    spins: torch.Tensor  # (K, N) real, entries in {-1, +1}
    y: torch.Tensor  # (K, H) complex pre-activations
    sa: torch.Tensor  # (K,) complex visible-bias term


def _real_matmul(s: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """real (K, N) @ complex (N, ...) as two real products."""
    return torch.complex(s @ m.real, s @ m.imag)


def _hidden_sum(work: Work, ly: torch.Tensor) -> torch.Tensor:
    """sum_j c_j * ly[..., j] over the hidden axis."""
    if work.c is None:
        return ly.sum(-1)
    return ly @ work.c


def cache_log_psi(work: Work, cache: Cache) -> torch.Tensor:
    """ln psi (K,) complex of the cached states, from y and sa."""
    return _hidden_sum(work, logcosh(cache.y)) + cache.sa


def full_forward(work: Work, spins: torch.Tensor) -> tuple[Cache, torch.Tensor]:
    """From-scratch forward: build the cache and ln psi for all walkers."""
    s = spins.to(work.w.real.dtype)
    y = _real_matmul(s, work.w) + work.b
    if work.a is not None:
        sa = _real_matmul(s, work.a)
    else:
        sa = torch.zeros(s.shape[0], dtype=work.w.dtype, device=s.device)
    cache = Cache(spins=s, y=y, sa=sa)
    return cache, cache_log_psi(work, cache)


def log_psi(work: Work, spins: torch.Tensor) -> torch.Tensor:
    """Pure fixed-spin ln psi (K,) complex."""
    return full_forward(work, spins)[1]


def flip_log_psi(work: Work, cache: Cache, site: int) -> torch.Tensor:
    """ln psi of the candidate state with `site` flipped in every walker."""
    two_s = 2.0 * cache.spins[:, site]  # (K,) real
    y1 = cache.y - two_s[:, None] * work.w[site]
    lnpsi = _hidden_sum(work, logcosh(y1)) + cache.sa
    if work.a is not None:
        lnpsi = lnpsi + (-two_s) * work.a[site]
    return lnpsi


def flip_log_psi_per_walker(work: Work, cache: Cache, sites: torch.Tensor) -> torch.Tensor:
    """ln psi with a per-walker flip site, sites (K,) int."""
    k = torch.arange(cache.spins.shape[0], device=cache.spins.device)
    two_s = 2.0 * cache.spins[k, sites]  # (K,) real
    y1 = cache.y - two_s[:, None] * work.w[sites]
    lnpsi = _hidden_sum(work, logcosh(y1)) + cache.sa
    if work.a is not None:
        lnpsi = lnpsi + (-two_s) * work.a[sites]
    return lnpsi


def commit_flip(work: Work, cache: Cache, site: int, accept: torch.Tensor) -> Cache:
    """Commit the single-site flip on walkers where `accept` is True.

    Branchless masked update: y and sa move by the pre-flip spin value, then
    the spin is negated. Returns a new Cache; the input is left unchanged.
    """
    acc = accept.to(cache.spins.dtype)
    two_s = (2.0 * cache.spins[:, site]) * acc  # 0 where rejected
    y = cache.y - two_s[:, None] * work.w[site]
    sa = cache.sa
    if work.a is not None:
        sa = sa - two_s * work.a[site]
    spins = cache.spins.clone()
    spins[:, site] *= 1.0 - 2.0 * acc
    return Cache(spins=spins, y=y, sa=sa)


def all_flip_log_psi(work: Work, cache: Cache, sites: torch.Tensor) -> torch.Tensor:
    """ln psi of every single-site flip in `sites` for every walker: (K, n).

    y1[k,i,j] = y[k,j] - 2 s[k,i] W[i,j], then log-cosh and the hidden sum.
    Memory O(K * n * H); callers chunk over `sites`.
    """
    two_s = 2.0 * cache.spins[:, sites]  # (K, n) real
    y1 = cache.y[:, None, :] - two_s[:, :, None] * work.w[sites][None]
    lnpsi = _hidden_sum(work, logcosh(y1)) + cache.sa[:, None]
    if work.a is not None:
        lnpsi = lnpsi + (-two_s) * work.a[sites][None, :]
    return lnpsi


def flip2_log_psi_per_walker(work: Work, cache: Cache, sites1: torch.Tensor, sites2: torch.Tensor) -> torch.Tensor:
    """ln psi with two per-walker flips, sites1 and sites2 each (K,) int:
    the pair-exchange proposal of the Kawasaki sampler."""
    k = torch.arange(cache.spins.shape[0], device=cache.spins.device)
    t1 = 2.0 * cache.spins[k, sites1]  # (K,) real
    t2 = 2.0 * cache.spins[k, sites2]
    y1 = cache.y - t1[:, None] * work.w[sites1] - t2[:, None] * work.w[sites2]
    lnpsi = _hidden_sum(work, logcosh(y1)) + cache.sa
    if work.a is not None:
        lnpsi = lnpsi + (-t1 * work.a[sites1] - t2 * work.a[sites2])
    return lnpsi


def commit_flip2_per_walker(
    work: Work, cache: Cache, sites1: torch.Tensor, sites2: torch.Tensor, accept: torch.Tensor
) -> Cache:
    """Commit per-walker pair flips where `accept` is True (Kawasaki
    exchange). Returns a new Cache; the input is left unchanged."""
    k = torch.arange(cache.spins.shape[0], device=cache.spins.device)
    acc = accept.to(cache.spins.dtype)
    t1 = (2.0 * cache.spins[k, sites1]) * acc  # 0 where rejected
    t2 = (2.0 * cache.spins[k, sites2]) * acc
    y = cache.y - t1[:, None] * work.w[sites1] - t2[:, None] * work.w[sites2]
    sa = cache.sa
    if work.a is not None:
        sa = sa - t1 * work.a[sites1] - t2 * work.a[sites2]
    spins = cache.spins.clone()
    spins[k, sites1] *= 1.0 - 2.0 * acc
    spins[k, sites2] *= 1.0 - 2.0 * acc
    return Cache(spins=spins, y=y, sa=sa)


def all_flip2_log_psi(work: Work, cache: Cache, sites_a: torch.Tensor, sites_b: torch.Tensor) -> torch.Tensor:
    """ln psi of every pair flip (a_t, b_t) shared across walkers: (K, T).

    y1[k,t,j] = y[k,j] - 2 s[k,a_t] W[a_t,j] - 2 s[k,b_t] W[b_t,j]; memory
    O(K * T * H), so callers chunk over the pairs.
    """
    ta = 2.0 * cache.spins[:, sites_a]  # (K, T) real
    tb = 2.0 * cache.spins[:, sites_b]
    y1 = cache.y[:, None, :] - ta[:, :, None] * work.w[sites_a][None] - tb[:, :, None] * work.w[sites_b][None]
    lnpsi = _hidden_sum(work, logcosh(y1)) + cache.sa[:, None]
    if work.a is not None:
        lnpsi = lnpsi + (-ta * work.a[sites_a][None, :] - tb * work.a[sites_b][None, :])
    return lnpsi


def _bounded_parts(x: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(log-magnitude residual, phase) of ln cosh(x + iv) without its |x| -
    ln 2 part: both bounded by O(1), so a float32 evaluation carries only
    ~eps absolute error."""
    e = torch.exp(-2.0 * x.abs())
    sgn = 1.0 - 2.0 * (x < 0).to(x.dtype)
    pre = (1.0 + e) * torch.cos(v)
    pim = (1.0 - e) * torch.sin(v) * sgn
    return 0.5 * torch.log(pre * pre + pim * pim), torch.atan2(pim, pre)


def all_flip_delta_log_psi(work: Work, cache: Cache, sites: torch.Tensor, accum_dtype=None) -> torch.Tensor:
    """ln psi(flip_i s) - ln psi(s) for every site in `sites`: (K, n), the
    compensated form (``energy_dtype="compensated"``).

    The per-hidden-unit differences ln cosh(y') - ln cosh(y) are formed
    first, each O(|2 s w|) and so exact to float32 eps of a small number,
    and only then summed, in `accum_dtype` (float64) when given: the two
    O(|ln psi|) totals of the plain form never cancel. The |x| part of each
    difference is taken exactly in the accumulation dtype, the angles are
    folded into (-pi, pi] there before the float32 cos/sin, and only the
    bounded log/atan2 parts (``_bounded_parts``) are evaluated in float32.
    sa cancels and never appears.
    """
    adt = cache.y.real.dtype if accum_dtype is None else accum_dtype
    two_s = 2.0 * cache.spins[:, sites]  # (K, n) real
    t_re = two_s[:, :, None] * work.w.real[sites][None]
    t_im = two_s[:, :, None] * work.w.imag[sites][None]
    x0 = cache.y.real[:, None, :].to(adt)
    v0 = cache.y.imag[:, None, :].to(adt)
    x1 = x0 - t_re.to(adt)
    v1 = v0 - t_im.to(adt)
    dabs = x1.abs() - x0.abs()
    two_pi = 2.0 * math.pi
    v0_f = v0 - two_pi * torch.round(v0 * (1.0 / two_pi))
    v1_f = v1 - two_pi * torch.round(v1 * (1.0 / two_pi))
    f32 = torch.float32
    lr1, li1 = _bounded_parts(x1.to(f32), v1_f.to(f32))
    lr0, li0 = _bounded_parts(x0.to(f32), v0_f.to(f32))
    dly = torch.complex((lr1.to(adt) - lr0.to(adt)) + dabs, li1.to(adt) - li0.to(adt))
    cdt = dly.dtype
    d = dly.sum(-1) if work.c is None else (dly * work.c.to(cdt)).sum(-1)
    if work.a is not None:
        d = d + (-two_s.to(adt)) * work.a[sites].to(cdt)[None, :]
    return d
