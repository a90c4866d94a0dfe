"""The float64 exchange instances' arithmetic, on the CPU.

``csrc/exchange_f64.cu`` runs only on the card. ``exchange_model`` below is
a float64 numpy transcription of its arithmetic, lane by lane at the
kernel's lanes per walker G (``lanes_f64``: hidden unit j on lane j % G,
unit j // G of it): the pick of the active bond (i, k) from the uniforms;
per unit E_j = e^{4 s (w_ij - w_kj)} from the bond's row of
``engine.exchange_table_f64`` and the factor c_j + u_j E_j; without output
weights c each |.|^2 brought into [1, 2) by its own power of two, the lane's
product, its carried inverse product of the |D_j|^2, the butterfly product
over the walker's G lanes and the two sites' factors e^{-4 s Re a'} = m 2^k;
with c the logs, the Args and the wrap of the flipped unit's phase onto the
principal branch; the per-unit state carried through accepted pair flips
and renewed from y at the start and after every sweep of n_unit proposals
(tempered: before the swap phases, which read the renewed Re ln psi). Its
fused multiply-adds are plain products and sums here, and a tempered row's
test is the kernel's exact comparison u^{1/beta} < |psi'/psi|^2.

It is held, on shared uniforms, to the port's plain float64 exchange
(``ops/exchange.py::tempered_exchange_plain``) and to the JAX package's
float64 ``sampler/kawasaki.py::_exchange_scan`` (tempered: with
``sampler/tempering.py::_swap_phase``, as ``tempered_exchange_sweeps``
composes them): the same decisions, y and sa equal to the plain version's to
the bit, the same counts, and the model's own Re ln psi (renewed, then
carried by its accepted ratios) within 1e-10 of the plain version's and of
JAX's. Inputs: the Hubbard RBM and FFNN at N = 16 and 64 on two rings of
bonds; the five ``utils/f64_stress.py`` cases with and without c on a ring
(one at |Re w| = 25, where a lane's factors leave the double range unless
each is renormalised); one launch of 100 sweeps; n_beta = 4 with the swap
phases. With c, walkers whose phase came within ``BRANCH_CUT_TOL_F64`` of pi
in the model are counted apart. The kernel itself is held to the plain
exchange on the card (``test_torch_gpu.py``, ``chip_smoke.py``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_network_quantum_state_tpu import models as jmodels
from neural_network_quantum_state_tpu.ops import engine as jengine
from neural_network_quantum_state_tpu.ops.cplx import C
from neural_network_quantum_state_tpu.sampler import kawasaki as jkawasaki
from neural_network_quantum_state_tpu.sampler import tempering as jtempering
from neural_network_quantum_state_tpu_torch import f64_ab
from neural_network_quantum_state_tpu_torch import models as tmodels
from neural_network_quantum_state_tpu_torch.models import params_from_jax
from neural_network_quantum_state_tpu_torch.ops import build, energy, engine
from neural_network_quantum_state_tpu_torch.ops import exchange as exchange_ops
from neural_network_quantum_state_tpu_torch.ops import sweep as sweep_ops
from neural_network_quantum_state_tpu_torch.ops.engine import Work
from neural_network_quantum_state_tpu_torch.ops.logcosh import BRANCH_CUT_TOL_F64
from neural_network_quantum_state_tpu_torch.sampler.kawasaki import ring_bonds, two_ring_bonds
from neural_network_quantum_state_tpu_torch.utils.f64_stress import F64_STRESS, f64_stress_inputs

from test_torch_energy import _np

LN_ATOL = 1e-10  # the model's Re ln psi against the plain version's and JAX's
Y_JAX_RTOL = 1e-13  # y against JAX's (XLA rounds y - 2 s w otherwise; the plain version's y is held to the bit)
NEAR_CUT_MAX = 1e-2  # with c: the largest share of walkers counted apart at the cut
LN_DOUBLE_MAX = math.log(np.finfo(np.float64).max)
RENORM = 4  # csrc/exchange_f64.cu kRenormF64 (a renewal's product of |D_j|^2)
LN2, TWO_PI, INV_TWO_PI, INV_LN2 = 0.6931471805599453, 6.283185307179586, 0.15915494309189535, 1.4426950408889634
LN2_HI, LN2_LO = 6.93147180369123816490e-01, 1.90821492927058770002e-10
TINY = np.finfo(np.float64).tiny

_jax_exchange_scan = jax.jit(lambda work, cache, ln, bonds, u_sel, u_acc, beta: jkawasaki._exchange_scan(
    work, cache, ln, bonds, u_sel, u_acc, beta=beta))
_jax_swap_phase = jax.jit(jtempering._swap_phase, static_argnums=(3, 4, 5))


def lanes_f64(h):
    """csrc/exchange_f64.cuh lanes_f64: the lanes per walker G at H hidden units."""
    return 16 if h <= 128 else 32


def _renorm(m, e):
    """The kernel's renorm of m 2^e (m >= 0): the biased exponent b of m
    (0 for zeros and subnormals) clamped to [1, 2045], m scaled by
    2^(1023 - b)."""
    b = np.clip(np.where(m >= TINY, np.frexp(m)[1] + 1022, 1), 1, 2045)
    return np.ldexp(m, 1023 - b), e + b - 1023


class _Lanes:
    """(K, H) arrays as (K, G, U): unit j on lane j % G, unit j // G of it."""

    def __init__(self, h):
        self.h, self.g = h, lanes_f64(h)
        self.u = -(-h // self.g)
        self.valid = (np.arange(self.u)[None, :] * self.g + np.arange(self.g)[:, None]) < h

    def __call__(self, x, fill=0.0):
        k = x.shape[0]
        out = np.full((k, self.u * self.g), fill, dtype=x.dtype)
        out[:, :self.h] = x
        return out.reshape(k, self.u, self.g).transpose(0, 2, 1)

    def butterfly(self, x, op):
        """op over the G lanes of axis 1 by xor pairs, as the kernel's
        shuffles; every lane ends with the same value."""
        lanes = np.arange(self.g)
        off = self.g // 2
        while off:
            x = op(x, x[:, lanes ^ off])
            off //= 2
        return x


def exchange_model(work, cache, bonds, u_sel, u_acc, n_beta=1, n_unit=None, swap_uniforms=None):
    """The float64 kernel's proposals on caller uniforms (n_steps, K), per
    walker row, renewed every n_unit proposals (None: once); for n_beta > 1
    the swap phases after each sweep of n_unit. Returns (spins, y, sa, Re
    ln psi as the model carries it, accepted proposals per row, accepted
    swaps per lower row, walkers near the cut (with c), and without c the
    largest ln of a walker's product of the |c_j + u_j E_j|^2 over its units
    and of one of them, unscaled)."""
    etab, a_site = (x.numpy() for x in engine.exchange_table_f64(work, torch.as_tensor(bonds)))
    w, a = work.w.numpy(), (np.zeros(work.w.shape[0], complex) if work.a is None else work.a.numpy())
    has_c = work.c is not None
    spins, y, sa = cache.spins.numpy().copy(), cache.y.numpy().copy(), cache.sa.numpy().copy()
    bonds = np.asarray(bonds)
    k, n = spins.shape
    lay = _Lanes(y.shape[1])
    valid = lay.valid[None]
    n_steps = u_sel.shape[0]
    n_unit = n_steps if n_unit is None else n_unit
    rows = np.arange(k)
    beta = (n_beta - rows % n_beta) / n_beta if n_beta > 1 else np.ones(k)
    near, n_acc, n_swap = np.zeros(k, bool), np.zeros(k), np.zeros(k)
    ln_unscaled = ln_factor = -np.inf
    if has_c:
        cl = lay(work.c.numpy()[None], 0.0)[0]  # (G, U)
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
        re, im = (1.0 + e) * cv, (1.0 - e) * sv * np.where(pos, 1.0, -1.0)
        if has_c:
            lnd, li = 0.5 * np.log(re * re + im * im), np.arctan2(im, re)
            near[:] |= (np.where(valid, np.abs(li), 0.0) > math.pi - BRANCH_CUT_TOL_F64).any((1, 2))
            st["q"] = np.where(valid, cl.real * lnd - cl.imag * li, 0.0).sum(2)
            ln = np.where(valid, cl.real * (lnd + (ax - LN2)) - cl.imag * li, 0.0)
        else:
            dd = (1.0 - e) ** 2 + 4.0 * e * cv * cv
            pd, ed = np.ones((k, lay.g)), np.zeros((k, lay.g), int)
            for r in range(lay.u):
                pd = np.where(valid[..., r], pd * dd[..., r], pd)
                if r % RENORM == RENORM - 1:
                    pd, ed = _renorm(pd, ed)
            pd, ed = _renorm(pd, ed)
            st["dm"], st["de"] = 1.0 / pd, -ed
            ln = np.where(valid, 0.5 * np.log(re * re + im * im) + (ax - LN2), 0.0)
        return lay.butterfly(ln.sum(2), np.add)[:, 0] + sa.real

    def table_e(bond, sign):
        """E_j = e^{4 s (w_ij - w_kj)} of each walker's bond (i, k), as (K, G, U)."""
        return lay(etab[bond, sign])

    def propose(bond, i, j, sign, t1):
        """(|psi'/psi|^2 as m 2^e, or with c dln; the proposal's parts)."""
        nonlocal ln_unscaled, ln_factor
        e = table_e(bond, sign)
        u, c = st["u"], st["c"]
        mx = u.real * e.real - u.imag * e.imag + c
        my = u.real * e.imag + u.imag * e.real
        m2 = mx * mx + my * my
        if has_c:
            v = lay(y.imag)
            dv = -t1[:, None, None] * lay(w[i].imag - w[j].imag)
            ph = (v - TWO_PI * np.rint(v * INV_TWO_PI) + dv) + np.arctan2(my, mx)
            ph = ph - TWO_PI * np.rint(ph * INV_TWO_PI)
            near[:] |= (np.where(valid, np.abs(ph), 0.0) > math.pi - BRANCH_CUT_TOL_F64).any((1, 2))
            acc = np.where(valid, cl.real * (0.5 * np.log(m2)) - cl.imag * ph, 0.0).sum(2)
            dln = lay.butterfly(acc - st["q"], np.add)[:, 0] - t1 * (a_site[i].real - a_site[j].real)
            return dln, acc
        f = np.where(valid, m2, 1.0)
        ln_unscaled = max(ln_unscaled, float(np.log(f).sum((1, 2)).max()))
        ln_factor = max(ln_factor, float(np.log(f).max()))
        pm, pe = np.ones((k, lay.g)), np.zeros((k, lay.g), int)
        for r in range(lay.u):  # each factor into [1, 2)
            fr, pe = _renorm(f[..., r], pe)
            pm = pm * fr
        z, ez = _renorm(pm * st["dm"], pe + st["de"])
        z, ez = lay.butterfly(z, np.multiply)[:, 0], lay.butterfly(ez, np.add)[:, 0]
        z, ez = z * (site_m[i, sign] * site_m[j, 1 - sign]), ez + site_k[i, sign] + site_k[j, 1 - sign]
        return (z, ez), (pm, pe)

    def accept(rows_, bond, i, j, sign, t1, part):
        e = table_e(bond, sign)[rows_]
        t2 = -t1
        for plane in ("real", "imag"):
            yp = getattr(y, plane)
            yp[rows_] = (yp[rows_] - t1[rows_, None] * getattr(w[i[rows_]], plane)) - t2[rows_, None] * getattr(
                w[j[rows_]], plane)
        u, c = st["u"][rows_], st["c"][rows_]
        ux = u.real * e.real - u.imag * e.imag
        uy = u.real * e.imag + u.imag * e.real
        mx = np.maximum(c, np.maximum(np.abs(ux), np.abs(uy)))
        b = np.clip(np.where(mx >= TINY, np.frexp(mx)[1] + 1022, 1), 1, 2045)
        expo = np.where(valid, b - 1023, 0)
        st["u"][rows_] = np.where(valid, np.ldexp(ux, -expo) + 1j * np.ldexp(uy, -expo), 0.0)
        st["c"][rows_] = np.where(valid, np.ldexp(c, -expo), 1.0)
        if has_c:
            st["q"][rows_] = part[rows_] - LN2 * (cl.real * expo).sum(2)
        else:
            pm, pe = part
            st["dm"][rows_] = 1.0 / pm[rows_]
            st["de"][rows_] = 2 * expo.sum(2) - pe[rows_]
        sa[rows_] = (sa[rows_] - t1[rows_] * a[i[rows_]]) - t2[rows_] * a[j[rows_]]
        spins[rows_, i[rows_]] = -spins[rows_, i[rows_]]
        spins[rows_, j[rows_]] = -spins[rows_, j[rows_]]

    ln_re = renew()
    for t in range(n_steps):
        if t > 0 and t % n_unit == 0 and n_beta == 1:
            ln_re = renew()
        active = spins[:, bonds[:, 0]] * spins[:, bonds[:, 1]] < 0
        nb = active.sum(1)
        target = np.minimum(np.floor(u_sel[t] * nb).astype(int), nb - 1)
        cs = np.cumsum(active, 1)
        bond = np.minimum((cs <= target[:, None]).sum(1), bonds.shape[0] - 1)
        i, j = bonds[bond, 0], bonds[bond, 1]
        sign = (spins[rows, i] < 0).astype(int)
        t1 = 2.0 * spins[rows, i]
        scale = 2.0 * beta
        if has_c:
            dln, part = propose(bond, i, j, sign, t1)
            ok = np.where(dln >= 0.0, u_acc[t] < 1.0, u_acc[t] < np.exp(scale * np.minimum(dln, 0.0)))
        else:
            (z, ez), part = propose(bond, i, j, sign, t1)
            l2 = ez * LN2 + np.log(z)  # 2 dln
            dln = 0.5 * l2
            if n_beta > 1:
                ok = np.where(l2 >= 0.0, u_acc[t] < 1.0, u_acc[t] < np.exp(beta * np.minimum(l2, 0.0)))
            else:
                ok = u_acc[t] < np.ldexp(z, ez)
        ok &= nb > 0
        accept(np.nonzero(ok)[0], bond, i, j, sign, t1, part)
        ln_re = np.where(ok, ln_re + dln, ln_re)
        n_acc += ok
        if n_beta > 1 and (t + 1) % n_unit == 0:
            ln_re = renew()
            sweep = t // n_unit
            for parity in (0, 1):
                r_ = rows % n_beta
                lower = ((r_ - parity) % 2 == 0) & (r_ >= parity) & (r_ + 1 < n_beta)
                upper = ((r_ - parity) % 2 == 1) & (r_ > parity)
                partner = np.where(lower, rows + 1, np.where(upper, rows - 1, rows))
                dl = ln_re[partner] - ln_re
                acc_lower = lower & (swap_uniforms[sweep, parity] < np.exp(2.0 * (1.0 / n_beta) * np.minimum(dl, 0.0)))
                n_swap += acc_lower
                moved = acc_lower | acc_lower[partner]
                src = np.where(moved, partner, rows)
                spins, y, sa, ln_re, near = spins[src], y[src], sa[src], ln_re[src], near[src]
                for key_ in st:
                    st[key_] = st[key_][src]
    return spins, y, sa, ln_re, n_acc, n_swap, near, (ln_unscaled, ln_factor)


def _jax_work(w, b, a, c):
    def cp(x):
        return None if x is None else C(jnp.asarray(x.real), jnp.asarray(x.imag))

    return jengine.Work(w=cp(w), b=cp(b), a=cp(a), c=cp(c))


def _jax_exchange(jwork, spins, bonds, u_sel, u_acc, n_beta=1, n_unit=None, u_swap=None):
    """JAX's float64 exchange rounds (and swap phases) on the same uniforms:
    (spins, y, ln psi)."""
    jcache, jln = jengine.full_forward(jwork, jnp.asarray(spins))
    jbonds = jnp.asarray(bonds)
    k = spins.shape[0]
    n_steps = u_sel.shape[0]
    n_unit = n_steps if n_unit is None else n_unit
    beta = jtempering.replica_betas(n_beta, k // n_beta, jnp.float64) if n_beta > 1 else None
    for s0 in range(0, n_steps, n_unit):
        span = slice(s0, s0 + n_unit)
        jcache, jln, _ = _jax_exchange_scan(jwork, jcache, jln, jbonds, jnp.asarray(u_sel[span]),
                                            jnp.asarray(u_acc[span]), beta)
        for parity in (0, 1) if n_beta > 1 else ():
            jcache, jln, _ = _jax_swap_phase(jcache, jln, jnp.asarray(u_swap[s0 // n_unit, parity]), parity, n_beta,
                                             k // n_beta)
    return np.asarray(jcache.spins), _np(jcache.y), _np(jln)


def _check(model, plain, n_rounds, jax_=None, has_c=False, n_beta=1):
    """Decisions (spins) equal on the walkers away from the cut (tempered:
    the chains without such a walker), y and sa equal to the plain
    version's to the bit there, the same counts, the model's Re ln psi within
    LN_ATOL of the plain version's and of JAX's."""
    spins, y, sa, ln_re, n_acc, n_swap, near, _ = model
    c_p, l_p, rows_p = plain
    near = near.reshape(-1, n_beta).any(1).repeat(n_beta)
    far = ~near if has_c else np.ones(spins.shape[0], bool)
    assert near.mean() <= NEAR_CUT_MAX
    np.testing.assert_array_equal(spins[far], c_p.spins.numpy()[far])
    assert np.array_equal(y[far], c_p.y.numpy()[far])
    assert np.array_equal(sa[far], c_p.sa.numpy()[far])
    np.testing.assert_allclose(ln_re[far], l_p.real.numpy()[far], rtol=0, atol=LN_ATOL)
    np.testing.assert_array_equal(n_acc[far], rows_p[0].numpy()[far])
    np.testing.assert_array_equal(n_swap[far], rows_p[1].numpy()[far])
    if jax_ is not None:
        jspins, jy, jln = jax_
        np.testing.assert_array_equal(spins[far], jspins[far])
        np.testing.assert_allclose(y[far], jy[far], rtol=0, atol=Y_JAX_RTOL * np.abs(jy).max())
        np.testing.assert_allclose(ln_re[far], jln.real[far], rtol=0, atol=LN_ATOL)
    assert 0.0 < n_acc.sum() < spins.shape[0] * n_rounds


def _run(work, cache, ln, bonds, u_sel, u_acc, n_beta=1, n_unit=None, u_swap=None):
    """The model and the plain (tempered) exchange with its per-row counts."""
    model = exchange_model(work, cache, bonds, u_sel, u_acc, n_beta, n_unit, u_swap)
    plain = exchange_ops.tempered_exchange_plain(
        work, cache, ln, torch.as_tensor(bonds), torch.as_tensor(u_sel), torch.as_tensor(u_acc), n_beta, n_unit,
        None if u_swap is None else torch.as_tensor(u_swap))
    return model, plain


def _inputs(w, b, a, c, spins):
    jwork = _jax_work(w, b, a, c)
    work = Work(*(None if x is None else torch.as_tensor(x) for x in (w, b, a, c)))
    cache, ln = engine.full_forward(work, torch.as_tensor(spins))
    return jwork, work, cache, ln


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("kind", ["RBM", "FFNN"])
@pytest.mark.parametrize("n", [16, 64])
def test_model_matches_plain_and_jax_on_hubbard_machines(kind, n, rng):
    """The Hubbard chain's RBM and FFNN at parameter scale 0.4, H = N (G = 16
    lanes of 1 and 4 units; N = 64 is the L = 32 flagship's shape), two
    sweeps of N proposals on the two rings of bonds."""
    jm = jmodels.get_machine(kind, n_inputs=n, n_hiddens=n, dtype=jnp.float64)
    tm = tmodels.get_machine(kind, n_inputs=n, n_hiddens=n, dtype=torch.float64)
    p_np = {name: 0.4 * (rng.normal(size=s) + 1j * rng.normal(size=s)) for name, s in jm.param_spec()}
    jwork = jm.make_work({name: C(jnp.asarray(v.real), jnp.asarray(v.imag)) for name, v in p_np.items()})
    work = tm.make_work(params_from_jax(tm, p_np, device="cpu"))
    k = 40
    spins = np.where(rng.random((k, n)) < 0.5, -1.0, 1.0)
    cache, ln = engine.full_forward(work, torch.as_tensor(spins))
    bonds = two_ring_bonds(n // 2)
    u_sel, u_acc = rng.random((2 * n, k)), rng.random((2 * n, k))
    model, plain = _run(work, cache, ln, bonds, u_sel, u_acc, n_unit=n)
    _check(model, plain, 2 * n, _jax_exchange(jwork, spins, bonds, u_sel, u_acc), has_c=work.c is not None)


@pytest.mark.parametrize("has_c", [False, True], ids=["rbm", "with_c"])
@pytest.mark.parametrize("case", F64_STRESS)
def test_model_matches_plain_and_jax_on_stress_inputs(case, has_c):
    """utils/f64_stress.py's inputs, two sweeps on a ring: large |Re w|
    (G = 16), a site whose unscaled product of factors leaves the double
    range (H = 512, G = 32), units near a zero of cosh, a site at |Re w| =
    25 whose factors leave it four at a time (G = 16)."""
    w, b, a, c, spins = f64_stress_inputs(case, has_c, seed=13)
    jwork, work, cache, ln = _inputs(w, b, a, c, spins)
    n = spins.shape[1]
    bonds = ring_bonds(n)
    urng = np.random.default_rng(19)
    u_sel, u_acc = urng.random((2 * n, spins.shape[0])), urng.random((2 * n, spins.shape[0]))
    model, plain = _run(work, cache, ln, bonds, u_sel, u_acc, n_unit=n)
    _check(model, plain, 2 * n, _jax_exchange(jwork, spins, bonds, u_sel, u_acc), has_c=has_c)
    if case == "overflow" and not has_c:  # a walker's product of factors leaves the double range unscaled
        assert model[-1][0] > LN_DOUBLE_MAX
    if case == "Re w 25" and not has_c:  # four factors leave it
        assert 4.0 * model[-1][1] > LN_DOUBLE_MAX


@pytest.mark.parametrize("has_c", [False, True], ids=["rbm", "with_c"])
def test_model_over_100_sweeps_in_one_launch(has_c):
    """A warm-up launch of 100 sweeps (renewed 100 times), where a drift of
    the carried state would show: the stress inputs' "large Re w" case."""
    w, b, a, c, spins = f64_stress_inputs("large Re w", has_c, seed=5, k=24)
    jwork, work, cache, ln = _inputs(w, b, a, c, spins)
    n = spins.shape[1]
    bonds = ring_bonds(n)
    urng = np.random.default_rng(29)
    u_sel, u_acc = urng.random((100 * n, spins.shape[0])), urng.random((100 * n, spins.shape[0]))
    model, plain = _run(work, cache, ln, bonds, u_sel, u_acc, n_unit=n)
    _check(model, plain, 100 * n, _jax_exchange(jwork, spins, bonds, u_sel, u_acc), has_c=has_c)


@pytest.mark.parametrize("has_c", [False, True], ids=["rbm", "with_c"])
def test_model_tempered_with_swap_phases(has_c, rng):
    """n_beta = 4, three sweeps each followed by the even and the odd swap
    phase on the renewed Re ln psi: against the plain tempered exchange and
    the JAX package's tempered rounds and swap phases."""
    n, n_beta, kb, n_sweeps = 16, 4, 8, 3
    k = n_beta * kb
    w, b, a, c, spins = f64_stress_inputs("scale 0.4", has_c, seed=31, k=k)
    jwork, work, cache, ln = _inputs(w, b, a, c, spins)
    bonds = two_ring_bonds(n // 2)
    u_sel, u_acc, u_swap = rng.random((n_sweeps * n, k)), rng.random((n_sweeps * n, k)), rng.random((n_sweeps, 2, k))
    model, plain = _run(work, cache, ln, bonds, u_sel, u_acc, n_beta, n, u_swap)
    _check(model, plain, n_sweeps * n, _jax_exchange(jwork, spins, bonds, u_sel, u_acc, n_beta, n, u_swap),
           has_c=has_c, n_beta=n_beta)
    assert float(plain[2][1].sum()) > 0  # some swaps taken


def test_sweep_table_f64_and_its_range_check_are_built_once_per_weight_tensor(monkeypatch):
    """engine.sweep_table_f64 keeps its last table, with the weights' range
    check, per device and thread: the same (w, a, c) return it without a
    new check; a new tensor, or w updated in place, builds anew."""
    w, b, a, c, _ = f64_stress_inputs("large Re w", False, seed=3, n=20)
    work = Work(*(None if x is None else torch.as_tensor(x).clone() for x in (w, b, a, c)))
    checks = []
    real_amax = torch.Tensor.amax
    monkeypatch.setattr(torch.Tensor, "amax", lambda self, *args, **kw: checks.append(1) or real_amax(self, *args, **kw))
    g1 = engine.sweep_table_f64(work)
    assert engine.sweep_table_f64(work) is g1 and len(checks) == 1
    other = Work(work.w.clone(), work.b, work.a, work.c)
    g2 = engine.sweep_table_f64(other)
    assert g2 is not g1 and len(checks) == 2 and torch.equal(g2[0], g1[0])
    work.w.mul_(0.5)  # in place: a new version
    g3 = engine.sweep_table_f64(work)
    assert g3 is not g1 and len(checks) == 3
    np.testing.assert_allclose(g3[0][:, 0].numpy(), np.exp(2.0 * w), rtol=1e-15)
    engine.check_f64_range(work.w)  # already checked at this version
    assert len(checks) == 3


@pytest.mark.parametrize("has_c", [False, True], ids=["rbm", "with_c"])
def test_exchange_table_f64_layout_and_memo(has_c, monkeypatch):
    """engine.exchange_table_f64: E (B, 2, H) = e^{4 s (w_i - w_k)} of each
    bond for s = +1 then -1, and the per-site term of kernel_table_f64; kept
    per (w, a, c, bonds), so a second call returns it, and new bonds build
    anew without a second range check of the same weights."""
    w, b, a, c, _ = f64_stress_inputs("large Re w", has_c, seed=4, n=20)
    work = Work(*(None if x is None else torch.as_tensor(x) for x in (w, b, a, c)))
    bonds = torch.as_tensor(two_ring_bonds(10))
    checks = []
    real_amax = torch.Tensor.amax
    monkeypatch.setattr(torch.Tensor, "amax", lambda self, *args, **kw: checks.append(1) or real_amax(self, *args, **kw))
    e, a_site = engine.exchange_table_f64(work, bonds)
    assert e.shape == (20, 2, w.shape[1]) and e.dtype == torch.complex128 and e.is_contiguous()
    for bond in (0, 7, 13, 19):
        i, k = (int(x) for x in bonds[bond])
        np.testing.assert_allclose(e[bond].numpy(), [np.exp(4.0 * (w[i] - w[k])), np.exp(-4.0 * (w[i] - w[k]))],
                                   rtol=1e-14)
    assert torch.equal(a_site, engine.kernel_table_f64(work)[1])
    assert engine.exchange_table_f64(work, bonds)[0] is e and len(checks) == 1
    ring = torch.as_tensor(ring_bonds(20))
    assert torch.equal(engine.exchange_table_f64(work, ring)[0][1], e[1]) and len(checks) == 1


@pytest.mark.parametrize("kernel", ["sweep", "exchange", "energy"])
def test_float64_wrappers_refuse_weights_past_the_range(kernel, monkeypatch):
    """The sweep, exchange and energy wrappers check |Re w| against the
    float64 kernels' one range (engine.F64_MAX_RE_W) after the device check
    and before any launch: the "Re w 25" inputs pass the check, one weight
    past the range raises (here the device check is passed over and a
    launch fails the test); the plain versions take such weights."""
    w, b, a, c, spins = f64_stress_inputs("Re w 25", False, seed=2, k=8)
    engine.check_f64_range(torch.as_tensor(w))
    w[3, 5] = engine.F64_MAX_RE_W + 1.0 + 0.1j
    work = Work(*(None if x is None else torch.as_tensor(x) for x in (w, b, a, c)))
    cache, ln = engine.full_forward(work, torch.as_tensor(spins))
    n = spins.shape[1]
    bonds, sched = torch.as_tensor(ring_bonds(n)), torch.arange(n, dtype=torch.int32)
    monkeypatch.setattr(build, "check_inputs", lambda *args, **kw: None)
    monkeypatch.setattr(build, "launch", lambda *args, **kw: pytest.fail("launched past the range"))
    u = torch.as_tensor(np.random.default_rng(1).random((n, spins.shape[0])))
    with pytest.raises(ValueError, match="Re w"):
        if kernel == "sweep":
            sweep_ops.sweep_cuda(work, cache, sched, u)
        elif kernel == "exchange":
            exchange_ops.exchange_cuda(work, cache, bonds, u, u)
        else:
            energy.offdiag_sum_cuda(work, cache)
    if kernel == "sweep":
        got = sweep_ops.sweep_plain(work, cache, ln, sched, u)[1]
    elif kernel == "exchange":
        got = exchange_ops.exchange_plain(work, cache, ln, bonds, u, u)[1]
    else:
        got = energy.offdiag_sum_plain(work, cache, ln)
    assert got.shape == (spins.shape[0],)
    assert not torch.isnan(got).any()


def test_f64_ab_reads_the_exchange_instances_and_a_parents_one_source(tmp_path):
    """The A/B's exchange side: every (G x U, c, tempered) instance's
    registers from ptxas -v, a parent's one instance per (c, tempered); a
    parent directory's one exchange_f64.cu builds both of its libraries."""
    mangled = "_ZN48_GLOBAL__N__005fe831_15_exchange_f64_cu_2f27ec6219exchange_kernel_f64I{}EEvNS_15ExchangeArgsF64E"
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{mangled.format('Li8ELi8ELb0ELb0E')}' for 'sm_90a'",
        "ptxas info    : Function properties: 8 bytes stack frame, 400 bytes spill stores, 400 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{mangled.format('Li32ELi12ELb1ELb1E')}' for 'sm_90a'",
        "ptxas info    : Used 254 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{mangled.format('Lb1ELb0E')}' for 'sm_90a'",
        "ptxas info    : Used 124 registers, used 1 barriers",
    ])
    assert f64_ab.registers(log) == {"8x8d": "128+400B", "32x12ctd": "254", "cd": "124"}
    (tmp_path / "exchange_f64.cu").write_text("")
    assert f64_ab.sources_of("exchange", tmp_path) == {"exchange_f64": tmp_path / "exchange_f64.cu",
                                                       "exchange_f64_tempered": tmp_path / "exchange_f64.cu"}
    (tmp_path / "exchange_f64_tempered.cu").write_text("")
    assert f64_ab.sources_of("exchange", tmp_path)["exchange_f64_tempered"] == tmp_path / "exchange_f64_tempered.cu"
