"""The float64 sweep instances' arithmetic, on the CPU.

``csrc/sweep_f64.cu`` runs only on the card. ``sweep_model`` below is a
float64 numpy transcription of its arithmetic, lane by lane (hidden unit j
on lane j % 32, word j // 32): the factors c_j + u_j G_ij over the table of
``engine.sweep_table_f64``; without output weights c the lane's product
of the |.|^2 in pairs, each pair brought into [1, 2) by its power of two,
the carried inverse product of the |D_j|^2, the butterfly
product over the warp and the per-site factor e^{-4 s Re a'_i} = m 2^k; with c the logs, the
Args and the wrap of the flipped unit's phase onto the principal branch;
the per-unit state carried through accepted flips and renewed at every
start of the schedule (and, tempered, before the swap phases). Its fused
multiply-adds are plain products and sums here, and a tempered row's test
is the kernel's exact comparison u^{1/beta} < |psi'/psi|^2 (the kernel's
float pre-test of the logs decides only where that comparison agrees).

It is held, on shared uniforms, to the port's plain float64 sweep
(``ops/sweep.py::sweep_plain``) and to the JAX package's float64
``sampler/metropolis.py::_sweep_scan`` (tempered: ``sampler/tempering.py``'s
rounds and swap phases): the same decisions, y equal to the plain
version's to the bit, and the model's own Re ln psi (renewed, then carried
by its accepted ratios) within 1e-10 of the plain version's. Inputs: five
machines of the registry at parameter scale 0.4 (N = 16 and 72), the five
``utils/f64_stress.py`` cases of the sweep with and without c (one at
|Re w| = 25, where a lane's factors leave the double range unless each
pair is renormalised), one launch of 100 sweeps
and n_beta = 4 with the swap phases. With c, walkers whose phase came
within ``BRANCH_CUT_TOL_F64`` of pi in the model are counted apart, as
``test_torch_energy_f64.py`` does. The kernel itself is held to the plain
sweep on the card (``test_torch_gpu.py``, ``chip_smoke.py``).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_network_quantum_state_tpu.ops import engine as jengine
from neural_network_quantum_state_tpu.ops.cplx import C
from neural_network_quantum_state_tpu.sampler import metropolis as jmetropolis
from neural_network_quantum_state_tpu.sampler import tempering as jtempering
from neural_network_quantum_state_tpu_torch import f64_ab
from neural_network_quantum_state_tpu_torch.ops import engine
from neural_network_quantum_state_tpu_torch.ops import sweep as sweep_ops
from neural_network_quantum_state_tpu_torch.ops.engine import Work
from neural_network_quantum_state_tpu_torch.ops.logcosh import BRANCH_CUT_TOL_F64
from neural_network_quantum_state_tpu_torch.sampler import chain_checkerboard
from neural_network_quantum_state_tpu_torch.utils.f64_stress import F64_STRESS, f64_stress_inputs

from test_torch_energy import _np, _setup

LN_ATOL = 1e-10  # the model's Re ln psi against the plain version's and JAX's
# y against JAX's (XLA rounds y - 2 s w otherwise than PyTorch does; the
# plain version's y is held to the bit)
Y_JAX_RTOL = 1e-13
NEAR_CUT_MAX = 1e-2  # with c: the largest share of walkers counted apart at the cut
LN_DOUBLE_MAX = math.log(np.finfo(np.float64).max)
LANES, RENORM = 32, 4  # csrc/sweep_f64.cu: lanes of a walker's warp, kRenorm (a renewal's product of |D_j|^2)
LN2, TWO_PI, INV_TWO_PI, INV_LN2 = 0.6931471805599453, 6.283185307179586, 0.15915494309189535, 1.4426950408889634
LN2_HI, LN2_LO = 6.93147180369123816490e-01, 1.90821492927058770002e-10
TINY = np.finfo(np.float64).tiny


def _renorm(m, e):
    """The kernel's renorm of m 2^e (m >= 0): the biased exponent b of m
    (0 for zeros and subnormals) clamped to [1, 2045], m scaled by
    2^(1023 - b)."""
    b = np.clip(np.where(m >= TINY, np.frexp(m)[1] + 1022, 1), 1, 2045)
    return np.ldexp(m, 1023 - b), e + b - 1023


def _warp_product(m, e):
    """The butterfly product over the lanes (last axis) of m in [1, 2),
    exponents summed; every lane ends with the same value."""
    lanes = np.arange(LANES)
    for off in (16, 8, 4, 2, 1):
        m, e = m * m[:, lanes ^ off], e + e[:, lanes ^ off]
    return m, e


def _warp_sum(x):
    lanes = np.arange(LANES)
    for off in (16, 8, 4, 2, 1):
        x = x + x[:, lanes ^ off]
    return x


class _Lanes:
    """(K, H) arrays as (K, LANES, R): unit j on lane j % 32, word j // 32."""

    def __init__(self, h):
        self.h, self.r = h, -(-h // LANES)
        self.valid = (np.arange(self.r)[None, :] * LANES + np.arange(LANES)[:, None]) < h

    def __call__(self, x, fill=0.0):
        k = x.shape[0]
        out = np.full((k, self.r * LANES), fill, dtype=x.dtype)
        out[:, :self.h] = x
        return out.reshape(k, self.r, LANES).transpose(0, 2, 1)


def sweep_model(work, cache, schedule, uniforms, n_beta=1, swap_uniforms=None):
    """The float64 kernel's sweeps on caller uniforms (n_steps, K), per
    walker row; for n_beta > 1 the swap phases after each sweep of
    len(schedule) rounds. Returns (spins, y, sa, Re ln psi as the model
    carries it, accepted flips per row, walkers near the cut (with c), and
    without c the largest ln of a walker's product of |c_j + u_j G_ij|^2
    over its units, unscaled)."""
    g, a_site = (x.numpy() for x in engine.sweep_table_f64(work))
    w, a = work.w.numpy(), (np.zeros(work.w.shape[0], complex) if work.a is None else work.a.numpy())
    has_c = work.c is not None
    cw = work.c.numpy() if has_c else None
    spins, y, sa = cache.spins.numpy().copy(), cache.y.numpy().copy(), cache.sa.numpy().copy()
    k, n = spins.shape
    h = y.shape[1]
    lay = _Lanes(h)
    valid = lay.valid[None]
    sched = [int(s) for s in schedule]
    n_sites, n_steps = len(sched), uniforms.shape[0]
    rows = np.arange(k)
    beta = (n_beta - rows % n_beta) / n_beta if n_beta > 1 else np.ones(k)
    near = np.zeros(k, bool)
    n_acc = np.zeros(k)
    ln_unscaled = -np.inf
    if has_c:
        cl = lay(cw[None], 0.0)[0]  # (LANES, R)
    else:  # e^{-4 s Re a'_i} = m 2^kk, s = +1 then -1
        f = np.stack((-4.0 * a_site.real, 4.0 * a_site.real), 1)
        kk = np.rint(f * INV_LN2)
        site_m, site_k = np.exp((f - kk * LN2_HI) - kk * LN2_LO), kk.astype(int)

    st = {}

    def renew():
        """The state from y; returns Re ln psi."""
        x, v = lay(y.real), lay(y.imag)
        ax, e = np.abs(x), np.exp(-2.0 * np.abs(x))
        sv, cv = np.sin(v), np.cos(v)
        pos = x >= 0.0
        us = np.where(pos, e, 1.0)
        st["u"] = np.where(valid, us * ((cv - sv) * (cv + sv)) - 1j * (us * (2.0 * sv * cv)), 0.0)
        st["c"] = np.where(valid, np.where(pos, 1.0, e), 1.0)
        if has_c:
            st["v"] = v - TWO_PI * np.rint(v * INV_TWO_PI)
            re, im = (1.0 + e) * cv, (1.0 - e) * sv * np.where(pos, 1.0, -1.0)
            lnd, li = 0.5 * np.log(re * re + im * im), np.arctan2(im, re)
            near[:] |= (np.where(valid, np.abs(li), 0.0) > math.pi - BRANCH_CUT_TOL_F64).any((1, 2))
            st["q"] = np.where(valid, cl.real * lnd - cl.imag * li, 0.0).sum(2)
            ln = np.where(valid, cl.real * (lnd + (ax - LN2)) - cl.imag * li, 0.0)
        else:
            dd = (1.0 - e) ** 2 + 4.0 * e * cv * cv
            pd, ed = np.ones((k, LANES)), np.zeros((k, LANES), int)
            for r in range(lay.r):
                pd = np.where(valid[..., r], pd * dd[..., r], pd)
                if r % RENORM == RENORM - 1:
                    pd, ed = _renorm(pd, ed)
            pd, ed = _renorm(pd, ed)
            st["dm"], st["de"] = 1.0 / pd, -ed
            re, im = (1.0 + e) * cv, (1.0 - e) * sv * np.where(pos, 1.0, -1.0)
            ln = np.where(valid, 0.5 * np.log(re * re + im * im) + (ax - LN2), 0.0)
        return _warp_sum(ln.sum(2))[:, 0] + sa.real

    def propose(site, sign, two_s):
        """(ratio |psi'/psi|^2 as m 2^e, its log, the state's proposal parts)."""
        nonlocal ln_unscaled
        gl = lay(g[site][sign])
        u, c = st["u"], st["c"]
        mx = u.real * gl.real - u.imag * gl.imag + c
        my = u.real * gl.imag + u.imag * gl.real
        m2 = mx * mx + my * my
        if has_c:
            ph = st["v"] - two_s[:, None, None] * lay(w[site][None].imag) + np.arctan2(my, mx)
            ph = ph - TWO_PI * np.rint(ph * INV_TWO_PI)
            near[:] |= (np.where(valid, np.abs(ph), 0.0) > math.pi - BRANCH_CUT_TOL_F64).any((1, 2))
            acc = np.where(valid, cl.real * (0.5 * np.log(m2)) - cl.imag * ph, 0.0).sum(2)
            dln = _warp_sum(acc - st["q"])[:, 0] - two_s * a_site[site].real
            return dln, acc
        f = np.where(valid, m2, 1.0)
        ln_unscaled = max(ln_unscaled, float(np.log(f).sum((1, 2)).max()))
        pm, pe = np.ones((k, LANES)), np.zeros((k, LANES), int)
        for g0 in range(0, lay.r, 4):  # in pairs, each pair into [1, 2)
            lo = f[..., g0] * f[..., g0 + 1] if g0 + 1 < lay.r else f[..., g0]
            hi = f[..., g0 + 2] * f[..., g0 + 3] if g0 + 3 < lay.r else f[..., g0 + 2] if g0 + 2 < lay.r else 1.0
            lo, pe = _renorm(lo, pe)
            hi, pe = _renorm(np.broadcast_to(hi, lo.shape), pe)
            pm = pm * (lo * hi)
        z, ez = _renorm(pm * st["dm"], pe + st["de"])
        z, ez = _warp_product(z, ez)
        z, ez = z[:, 0] * site_m[site, sign], ez[:, 0] + site_k[site, sign]
        return (z, ez), (pm, pe)

    def accept(rows_, site, sign, two_s, part):
        gl, wr = lay(g[site][sign]), w[site]
        y.real[rows_] -= two_s[rows_, None] * wr.real
        y.imag[rows_] -= two_s[rows_, None] * wr.imag
        u, c = st["u"][rows_], st["c"][rows_]
        ux = u.real * gl[rows_].real - u.imag * gl[rows_].imag
        uy = u.real * gl[rows_].imag + u.imag * gl[rows_].real
        mx = np.maximum(c, np.maximum(np.abs(ux), np.abs(uy)))
        b = np.clip(np.where(mx >= TINY, np.frexp(mx)[1] + 1022, 1), 1, 2045)
        expo = np.where(valid, b - 1023, 0)
        st["u"][rows_] = np.where(valid, np.ldexp(ux, -expo) + 1j * np.ldexp(uy, -expo), 0.0)
        st["c"][rows_] = np.where(valid, np.ldexp(c, -expo), 1.0)
        if has_c:
            ny = lay(y[rows_].imag)
            st["v"][rows_] = ny - TWO_PI * np.rint(ny * INV_TWO_PI)
            st["q"][rows_] = part[rows_] - LN2 * (cl.real * expo).sum(2)
        else:
            pm, pe = part
            st["dm"][rows_] = 1.0 / pm[rows_]
            st["de"][rows_] = 2 * expo.sum(2) - pe[rows_]
        sa[rows_] -= two_s[rows_] * a[site]
        spins[rows_, site] = -spins[rows_, site]

    ln_re = renew()
    sweep_len = n_sites if n_beta > 1 else n_steps
    for s0 in range(0, n_steps, sweep_len):
        for t in range(s0, s0 + sweep_len):
            if t % n_sites == 0 and t > 0 and n_beta == 1:
                ln_re = renew()
            site = sched[t % n_sites]
            sign = (spins[:, site] < 0).astype(int)
            two_s = 2.0 * spins[:, site]
            if has_c:
                dln, part = propose(site, sign, two_s)
                ok = np.where(dln >= 0.0, uniforms[t] < 1.0, uniforms[t] < np.exp(2.0 * beta * np.minimum(dln, 0.0)))
            else:
                (z, ez), part = propose(site, sign, two_s)
                l2 = ez * LN2 + np.log(z)  # 2 dln
                dln = 0.5 * l2
                if n_beta > 1:
                    ok = np.where(l2 >= 0.0, uniforms[t] < 1.0, uniforms[t] < np.exp(beta * np.minimum(l2, 0.0)))
                else:
                    ok = uniforms[t] < np.ldexp(z, ez)
            accept(np.nonzero(ok)[0], site, sign, two_s, part)
            ln_re = np.where(ok, ln_re + dln, ln_re)
            n_acc += ok
        if n_beta > 1:
            ln_re = renew()
            for parity in (0, 1):
                r_ = rows % n_beta
                lower = ((r_ - parity) % 2 == 0) & (r_ >= parity) & (r_ + 1 < n_beta)
                upper = ((r_ - parity) % 2 == 1) & (r_ > parity)
                partner = np.where(lower, rows + 1, np.where(upper, rows - 1, rows))
                dl = ln_re[partner] - ln_re
                acc_lower = lower & (swap_uniforms[s0 // n_sites, parity]
                                     < np.exp(2.0 * (1.0 / n_beta) * np.minimum(dl, 0.0)))
                moved = acc_lower | acc_lower[partner]
                src = np.where(moved, partner, rows)
                spins, y, sa, ln_re, near = spins[src], y[src], sa[src], ln_re[src], near[src]
                for key_ in st:
                    st[key_] = st[key_][src]
    return spins, y, sa, ln_re, n_acc, near, ln_unscaled


def _jax_work(w, b, a, c):
    def cp(x):
        return None if x is None else C(jnp.asarray(x.real), jnp.asarray(x.imag))

    return jengine.Work(w=cp(w), b=cp(b), a=cp(a), c=cp(c))


def _check(model, plain, jax_=None, has_c=False, n_beta=1):
    """Decisions (spins) equal on the walkers away from the cut (tempered:
    the chains without such a walker, whose swaps it could change), y and sa
    equal to the plain version's to the bit there (y to JAX's within
    Y_JAX_RTOL of its largest |value|), the model's Re ln psi within LN_ATOL
    of both."""
    spins, y, sa, ln_re, n_acc, near, _ = model
    (c_p, l_p, rows_p) = plain
    near = near.reshape(-1, n_beta).any(1).repeat(n_beta)
    far = ~near if has_c else np.ones(spins.shape[0], bool)
    assert near.mean() <= NEAR_CUT_MAX
    np.testing.assert_array_equal(spins[far], c_p.spins.numpy()[far])
    assert np.array_equal(y[far], c_p.y.numpy()[far])
    assert np.array_equal(sa[far], c_p.sa.numpy()[far])
    np.testing.assert_allclose(ln_re[far], l_p.real.numpy()[far], rtol=0, atol=LN_ATOL)
    np.testing.assert_array_equal(n_acc[far], rows_p[0].numpy()[far])
    if jax_ is not None:
        jspins, jy, jln = jax_
        np.testing.assert_array_equal(spins[far], jspins[far])
        np.testing.assert_allclose(y[far], jy[far], rtol=0, atol=Y_JAX_RTOL * np.abs(jy).max())
        np.testing.assert_allclose(ln_re[far], jln.real[far], rtol=0, atol=LN_ATOL)
    assert 0.0 < n_acc.sum() < spins.shape[0] * 1e9


def _run(work, cache, ln, sched, uniforms):
    """The model, the plain sweep and its per-row counts on one block."""
    model = sweep_model(work, cache, sched, uniforms)
    plain = sweep_ops.sweep_plain(work, cache, ln, torch.as_tensor(sched), torch.as_tensor(uniforms), rows=True)
    return model, plain


def _jax_sweeps(jwork, jcache, jln, sched, uniforms):
    jc, jl, _ = jmetropolis._sweep_scan(jwork, jcache, jln, jnp.asarray(np.tile(sched, uniforms.shape[0] // len(sched))),
                                       jnp.asarray(uniforms))
    return np.asarray(jc.spins), _np(jc.y), _np(jl)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("kind", ["RBMTrSymm", "RBM", "RBMZ2PrSymm", "FFNN", "FFNNTrSymm"])
@pytest.mark.parametrize("n", [16, 72])
def test_model_matches_plain_and_jax_on_machines(kind, n, rng):
    """Five machines at parameter scale 0.4, two sweeps on shared uniforms:
    N = 16 (every unit on one word at H = 12, 32, 48) and N = 72 (up to
    five words, the last partly padding)."""
    (jwork, jcache, jln), (work, cache, ln) = _setup(kind, n, 40, rng)
    sched = chain_checkerboard(n)
    uniforms = rng.random((2 * n, 40))
    model, plain = _run(work, cache, ln, sched, uniforms)
    _check(model, plain, _jax_sweeps(jwork, jcache, jln, sched, uniforms), has_c=work.c is not None)


@pytest.mark.parametrize("has_c", [False, True], ids=["rbm", "with_c"])
@pytest.mark.parametrize("case", F64_STRESS)
def test_model_matches_plain_and_jax_on_stress_inputs(case, has_c):
    """utils/f64_stress.py's inputs, two sweeps: large |Re w|, a site whose
    unscaled product of factors leaves the double range, units near a zero
    of cosh, a site at |Re w| = 25 whose factors leave it four at a time
    (a kernel that renormalised only groups of four would overflow)."""
    w, b, a, c, spins = f64_stress_inputs(case, has_c, seed=11)
    jwork = _jax_work(w, b, a, c)
    jcache, jln = jengine.full_forward(jwork, jnp.asarray(spins))
    work = Work(*(None if x is None else torch.as_tensor(x) for x in (w, b, a, c)))
    cache, ln = engine.full_forward(work, torch.as_tensor(spins))
    n = spins.shape[1]
    sched = np.arange(n)
    uniforms = np.random.default_rng(17).random((2 * n, spins.shape[0]))
    model, plain = _run(work, cache, ln, sched, uniforms)
    _check(model, plain, _jax_sweeps(jwork, jcache, jln, sched, uniforms), has_c=has_c)
    if case in ("overflow", "Re w 25") and not has_c:  # a lane's factors leave the double range unscaled
        assert model[-1] > LN_DOUBLE_MAX
    if case == "Re w 25" and not has_c:  # the flips of s_0 = +1 are decided by the uniforms
        flips = (spins[:, 0] > 0) & (plain[0].spins.numpy()[:, 0] < 0)
        assert 0 < flips.sum() < (spins[:, 0] > 0).sum()
    if case == "near a zero of cosh":  # |cosh y| <= 1.5e-3 at the chosen units
        assert (np.abs(np.cosh(cache.y[:4].numpy())).min(1) < 1.5e-3).all()


@pytest.mark.parametrize("has_c", [False, True], ids=["rbm", "with_c"])
def test_model_over_100_sweeps_in_one_launch(has_c):
    """A warm-up launch of 100 sweeps (renewed 100 times), where a drift of
    the carried state would show: the stress inputs' "large Re w" case."""
    w, b, a, c, spins = f64_stress_inputs("large Re w", has_c, seed=5, k=24)
    work = Work(*(None if x is None else torch.as_tensor(x) for x in (w, b, a, c)))
    cache, ln = engine.full_forward(work, torch.as_tensor(spins))
    n = spins.shape[1]
    sched = chain_checkerboard(n)
    uniforms = np.random.default_rng(23).random((100 * n, spins.shape[0]))
    model, plain = _run(work, cache, ln, sched, uniforms)
    jwork = _jax_work(w, b, a, c)
    jcache, jln = jengine.full_forward(jwork, jnp.asarray(spins))
    _check(model, plain, _jax_sweeps(jwork, jcache, jln, sched, uniforms), has_c=has_c)


@pytest.mark.parametrize("has_c", [False, True], ids=["rbm", "with_c"])
def test_model_tempered_with_swap_phases(has_c, rng):
    """n_beta = 4, three sweeps each followed by the even and the odd swap
    phase on the renewed Re ln psi: against the plain tempered sweep and the
    JAX package's tempered rounds and swap phases."""
    n, n_beta, kb, n_sweeps = 16, 4, 8, 3
    k = n_beta * kb
    (jwork, jcache, jln), (work, cache, ln) = _setup("FFNN" if has_c else "RBMTrSymm", n, k, rng)
    sched = chain_checkerboard(n)
    u_flip, u_swap = rng.random((n_sweeps * n, k)), rng.random((n_sweeps, 2, k))
    model = sweep_model(work, cache, sched, u_flip, n_beta, u_swap)
    plain = sweep_ops.sweep_plain(work, cache, ln, torch.as_tensor(sched), torch.as_tensor(u_flip), n_beta,
                                  torch.as_tensor(u_swap), rows=True)
    beta = jtempering.replica_betas(n_beta, kb, jnp.float64)
    for s in range(n_sweeps):
        jcache, jln, _ = jtempering._tempered_flip_scan(jwork, jcache, jln, jnp.asarray(sched),
                                                        jnp.asarray(u_flip[s * n:(s + 1) * n]), beta)
        for parity in (0, 1):
            jcache, jln, _ = jtempering._swap_phase(jcache, jln, jnp.asarray(u_swap[s, parity]), parity, n_beta, kb)
    _check(model, plain, (np.asarray(jcache.spins), _np(jcache.y), _np(jln)), has_c=has_c, n_beta=n_beta)
    assert float(plain[2][1].sum()) > 0  # some swaps taken


@pytest.mark.parametrize("has_c", [False, True], ids=["rbm", "with_c"])
def test_sweep_table_f64_layout(has_c):
    """G = e^{4 s w} as (site, sign, unit), s = +1 then -1, and the per-site
    term of kernel_table_f64; built apart from the float32 table's memo."""
    w, b, a, c, _ = f64_stress_inputs("large Re w", has_c, seed=3, n=70)
    work = Work(*(None if x is None else torch.as_tensor(x) for x in (w, b, a, c)))
    f32_memo = dict(engine.memo("kernel_table"))
    g, a_site = engine.sweep_table_f64(work)
    assert engine.memo("kernel_table").keys() == f32_memo.keys()
    n, h = w.shape
    assert g.shape == (n, 2, h) and g.dtype == torch.complex128 and g.is_contiguous()
    for i, j in ((0, 0), (5, 17), (n - 1, h - 1), (65, 40)):
        np.testing.assert_allclose(g[i, :, j].numpy(), [np.exp(4.0 * w[i, j]), np.exp(-4.0 * w[i, j])], rtol=1e-15)
    assert torch.equal(a_site, engine.kernel_table_f64(work)[1])
    shift = w.real @ c if has_c else w.sum(1)
    np.testing.assert_allclose(a_site.numpy(), (0.0 if a is None else a) + shift, rtol=1e-13)


def test_sweep_f64_ab_needs_a_cuda_device(monkeypatch, capsys):
    """The A/B entry point refuses to run without a CUDA device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert f64_ab.main([]) == 1
    assert "CUDA" in capsys.readouterr().err


def test_sweep_f64_ab_reads_the_instances_registers():
    """ptxas -v of a build: the R = 8, 12 and 16 instances of this source
    (template R, c, tempered, narrow) and a parent's instances for every R
    (c, tempered), with their spills."""
    mangled = "_ZN45_GLOBAL__N__0_12_sweep_f64_cu_0b16sweep_kernel_f64I{}EEvNS_12SweepArgsF64E"
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{mangled.format('Li8ELb1ELb0ELb0E')}' for 'sm_90a'",
        "ptxas info    : Function properties: 80 bytes stack frame, 60 bytes spill stores, 44 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{mangled.format('Li7ELb0ELb0ELb0E')}' for 'sm_90a'",
        "ptxas info    : Used 120 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{mangled.format('Li12ELb0ELb1ELb0E')}' for 'sm_90a'",
        "ptxas info    : Function properties: 8 bytes stack frame, 104 bytes spill stores, 104 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{mangled.format('Li16ELb0ELb1ELb1E')}' for 'sm_90a'",
        "ptxas info    : Used 254 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{mangled.format('Lb0ELb1E')}' for 'sm_90a'",
        "ptxas info    : Function properties: 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 64 registers, used 1 barriers",
    ])
    assert f64_ab.registers(log) == {"8cd": "128+60B", "12td": "128+104B", "16tnd": "254", "td": "64"}


def test_float64_sweep_kernel_refuses_weights_past_its_range():
    """The float64 kernel's wrapper checks |Re w| against the range of the
    float64 kernels' products (engine.F64_MAX_RE_W) before it launches: the
    stress inputs at |Re w| = 25 pass, one weight past the range raises; the
    plain sweep takes such weights."""
    w, b, a, c, spins = f64_stress_inputs("Re w 25", False, seed=2, k=8)
    engine.check_f64_range(torch.as_tensor(w))
    w.real[3, 5] = engine.F64_MAX_RE_W + 1.0
    work = Work(*(None if x is None else torch.as_tensor(x) for x in (w, b, a, c)))
    with pytest.raises(ValueError, match="Re w"):
        engine.check_f64_range(work.w)
    cache, ln = engine.full_forward(work, torch.as_tensor(spins))
    sched = torch.arange(spins.shape[1])
    u = torch.as_tensor(np.random.default_rng(1).random((spins.shape[1], spins.shape[0])))
    assert bool(torch.isfinite(sweep_ops.sweep_plain(work, cache, ln, sched, u)[1]).all())
