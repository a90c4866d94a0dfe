"""The float32 factor-form megakernel's arithmetic, on the CPU.

``csrc/sweep_energy.cu`` runs only on the card. ``megakernel_model`` below is
a float32 numpy transcription of its arithmetic, lane by lane (hidden unit j
on lane j % L, word j // L, with the kernel's L lanes a walker: 16 at n_beta
= 1 up to H = 128, else 32): the state (u_j, c_j) renewed from y at the
start and after every sweep, the table of ``engine.sweep_table_f32`` (e^{4 s
w}, the per-site factors m 2^k and the range class), the factors c_j +
u_j G_ij multiplied in pairs, each pair with its power of two, where every
|Re w| <= 5, else each brought into [1, 2) in its larger part by its own
before it is squared or multiplied, the lane's numerator and its carried
product of |D_j|^2, the warp's butterfly of the numerators with the
exponents summed apart and its carried product of the denominators, the
test u zd < a 2^d (a tempered row: the logs), the accepted flip's state
and the lane's and the warp's new denominators, and the
energy's complex product times the per-site factor and 1 / prod_j D_j. Its
fused multiply-adds are plain products and sums here, and the reduce-scatter
of the energy's products is a butterfly.

It is held, on shared uniforms, to the port's plain megakernel
(``ops/sweep_energy.py::sweeps_offdiag_plain``) and to the JAX package's XLA
composition (``metropolis._sweep_scan`` or the tempered rounds and swap
phases, then ``ising._offdiag_sum``), both in float32, at the card's
tolerances (``chip_smoke.py``): decisions on at most a share of 1e-3 of the
walkers apart, y within 1e-5 and the off-diagonal sums within 1e-5 of their
largest |value| on the others. On the stress inputs of
``utils/f32_stress.py`` (|Re w| = 20, a unit near a zero of cosh, large
|Re y|) the reference is the plain megakernel in float64 on the same
inputs: there the plain float32 version's dln, a difference of two ln psi
near 5000, loses about 3e-4 (and near a zero of cosh its 1 - e^{-2|x|}
loses its digits), so it parts from the exact decisions on more walkers than
the kernel does; y, which float32 holds to its ulp of about 4e-6 at
|y| = 45, is held there to 1e-5 of its largest |value|. The kernel itself is
held to the plain versions on the card (``test_torch_gpu.py``,
``chip_smoke.py``).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_network_quantum_state_tpu.hamiltonians import ising as jising
from neural_network_quantum_state_tpu.models import RBM as JRBM
from neural_network_quantum_state_tpu.models import RBMTrSymm as JRBMTrSymm
from neural_network_quantum_state_tpu.ops import engine as jengine
from neural_network_quantum_state_tpu.ops.cplx import C
from neural_network_quantum_state_tpu.sampler import metropolis as jmetropolis
from neural_network_quantum_state_tpu.sampler import tempering as jtempering
from neural_network_quantum_state_tpu_torch.models import RBM, RBMTrSymm, params_from_jax
from neural_network_quantum_state_tpu_torch.ops import build, engine
from neural_network_quantum_state_tpu_torch.ops import energy as energy_ops
from neural_network_quantum_state_tpu_torch.ops import sweep_energy
from neural_network_quantum_state_tpu_torch.ops.engine import Work
from neural_network_quantum_state_tpu_torch.sampler import chain_checkerboard
from neural_network_quantum_state_tpu_torch.utils.f32_stress import F32_STRESS, STRESS_RE_W, f32_stress_inputs

F32 = np.float32
# chip_smoke.py's SWEEP_MISMATCH_MAX, SWEEP_Y_ATOL and OFFDIAG_RTOL
MISMATCH_MAX, Y_ATOL, OFFDIAG_RTOL = 1e-3, 1e-5, 1e-5
LN2 = F32(0.6931471805599453)
LN_FLOAT_MAX = math.log(np.finfo(np.float32).max)


def _np(c):
    return np.asarray(c.re) + 1j * np.asarray(c.im)


def _exponent_bits(x):
    return np.asarray(x, F32).view(np.uint32) & np.uint32(0x7F800000)


def _down(eb):
    """2^(127 - e) for exponent bits e << 23 (csrc/sweep_energy.cu down_scale)."""
    return (np.uint32(0x7F000000) - eb).view(F32)


def _renorm(z):
    """z >= 0 as (z', k), z = z' 2^k, z' in [1, 2) (0 stays 0)."""
    eb = _exponent_bits(z)
    return z * _down(eb), (eb >> np.uint32(23)).astype(np.int64) - 127


def _renorm_pair(x, y):
    """(x, y) brought into [1, 2) in its larger part: (x', y', e - 127)."""
    eb = _exponent_bits(np.maximum(np.abs(x), np.abs(y)))
    r = _down(eb)
    return x * r, y * r, (eb >> np.uint32(23)).astype(np.int64) - 127


def _cmul(ax, ay, bx, by):
    return ax * bx - ay * by, ax * by + ay * bx


def _butterfly(op, *xs):
    """op over the lanes (axis 1) by the walker's butterfly: every lane ends
    with the combined value; lane 0's is returned."""
    lanes = np.arange(xs[0].shape[1])
    off = len(lanes)
    while (off := off // 2) > 0:
        xs = op(xs, tuple(x[:, lanes ^ off] for x in xs))
    return tuple(x[:, 0] for x in xs)


class _Lanes:
    """(K, H) arrays as (K, L, R): unit j on lane j % L, word j // L, with R
    twice ceil(H/32) at L = 16, as the kernel's instances have it."""

    def __init__(self, h, lanes):
        self.h, self.lanes, self.r = h, lanes, -(-h // 32) * (32 // lanes)
        self.valid = (np.arange(self.r)[None, :] * lanes + np.arange(lanes)[:, None]) < h

    def __call__(self, x, fill=0.0):
        k = x.shape[0]
        out = np.full((k, self.r * self.lanes), fill, dtype=x.dtype)
        out[:, :self.h] = x
        return out.reshape(k, self.r, self.lanes).transpose(0, 2, 1)


def megakernel_model(work, cache, schedule, uniforms, n_beta=1, swap_uniforms=None):
    """The megakernel on caller uniforms (n_steps, K) in float32, per walker
    row; for n_beta > 1 the swap phases after each sweep of len(schedule)
    rounds. Returns (spins, y, sa, accepted flips per row, off-diagonal sums
    (K,) complex64, the largest ln |c_j + u_j G_ij|^2 of a proposal,
    unscaled)."""
    g, site_tab, narrow = engine.sweep_table_f32(work)
    g, site_tab = g.numpy(), site_tab.numpy()
    w = work.w.numpy()
    a = work.a.numpy() if work.a is not None else np.zeros(w.shape[0], np.complex64)
    spins, y, sa = cache.spins.numpy().copy(), cache.y.numpy().copy(), cache.sa.numpy().copy()
    k, n = spins.shape
    h = y.shape[1]
    lay = _Lanes(h, 16 if n_beta == 1 and h <= 128 else 32)
    valid = lay.valid[None]
    sched = [int(s) for s in schedule]
    n_sites, n_steps = len(sched), uniforms.shape[0]
    rows = np.arange(k)
    inv_beta = (F32(n_beta) / (n_beta - rows % n_beta)).astype(F32)
    n_acc = np.zeros(k)
    st = {"ln_factor_max": -np.inf}

    def prod_over_r(x):
        out = np.ones(x.shape[:2], F32)
        for r in range(lay.r):
            out = out * x[..., r]
        return out

    def cprod_over_r(x, y_):
        px, py = np.ones(x.shape[:2], F32), np.zeros(x.shape[:2], F32)
        for r in range(lay.r):
            px, py = _cmul(px, py, x[..., r], y_[..., r])
        return px, py

    def cmul_e(p, q):  # (x, y, e)
        return (*_cmul(p[0], p[1], q[0], q[1]), p[2] + q[2])

    def renew(logs):
        """The state from y; returns Re ln psi when logs."""
        x, v = lay(y.real), lay(y.imag)
        with np.errstate(under="ignore"):
            ax, e = np.abs(x), np.exp(F32(-2) * np.abs(x))
            ome = -np.expm1(F32(-2) * ax)
        sv, cv = np.sin(v), np.cos(v)
        pos = x >= 0
        us = np.where(pos, e, F32(1))
        st["ur"] = np.where(valid, us * ((cv - sv) * (cv + sv)), F32(0))
        st["ui"] = np.where(valid, -us * (F32(2) * sv * cv), F32(0))
        st["c"] = np.where(valid, np.where(pos, F32(1), e), F32(1))
        p, q = (F32(1) + e) * cv, np.where(pos, ome, -ome) * sv
        d2 = p * p + q * q
        qd, ed = _renorm(np.where(valid, d2, F32(1)))
        st["dm"], el = _renorm(prod_over_r(qd))  # the lane's prod_j |D_j|^2 = dm 2^de
        st["de"] = ed.sum(-1) + el
        (zd,) = _butterfly(lambda s_, o: (s_[0] * o[0],), st["dm"])
        st["zd"], st["kd"] = _renorm(zd)  # the warp's product of the lanes' dm
        fx, fy, fe = _renorm_pair(np.where(valid, p * cv + q * sv, F32(1)), np.where(valid, q * cv - p * sv, F32(0)))
        dx, dy = cprod_over_r(fx, fy)
        dx, dy, e1 = _renorm_pair(dx, dy)
        dx, dy, dex = _butterfly(lambda s_, o: cmul_e(s_, o), dx, dy, fe.sum(-1) + e1)
        dx, dy, e2 = _renorm_pair(dx, dy)
        inv = F32(1) / (dx * dx + dy * dy)
        st["dinv"] = (dx * inv, -dy * inv, -(dex + e2))
        if not logs:
            return None
        lnc = np.where(valid, F32(0.5) * np.log(np.where(valid, d2, F32(1))) + (ax - LN2), F32(0))
        lane = np.zeros((k, lay.lanes), F32)
        for r in range(lay.r):
            lane = lane + lnc[..., r]
        return _butterfly(lambda s_, o: (s_[0] + o[0],), lane)[0] + sa.real

    def factors(gl):
        """c + u G of every unit (1 past H)."""
        mx = (st["c"] - st["ui"] * gl.imag) + st["ur"] * gl.real
        my = st["ur"] * gl.imag + st["ui"] * gl.real
        with np.errstate(divide="ignore"):
            lf = np.log(mx.astype(np.float64) ** 2 + my.astype(np.float64) ** 2)
        st["ln_factor_max"] = max(st["ln_factor_max"], float(np.where(valid, lf, -np.inf).max()))
        return mx, my

    def pairs(x, fill=1.0):
        """x (K, L, R) as pairs along r, the last one with fill when R is odd."""
        if lay.r % 2:
            x = np.concatenate((x, np.full(x.shape[:2] + (1,), fill, x.dtype)), -1)
        return x[..., 0::2], x[..., 1::2]

    def propose(gl):
        """The lane's numerator p 2^pe and the warp's zn 2^kn and zn / zd 2^x."""
        mx, my = factors(gl)
        if narrow:  # the |.|^2 in pairs, each pair's product into [1, 2)
            qa, qb = pairs(mx * mx + my * my)
            p, pe = np.ones((k, lay.lanes), F32), np.zeros((k, lay.lanes), np.int64)
            for r in range(qa.shape[-1]):
                p, kp = _renorm(p * (qa[..., r] * qb[..., r]))
                pe += kp
        else:  # each factor into [1, 2) before it is squared
            mx, my, e = _renorm_pair(mx, my)
            p, kl = _renorm(prod_over_r(mx * mx + my * my))
            pe = kl + 2 * e.sum(-1)
        zn, x = _butterfly(lambda s_, o: (s_[0] * o[0], s_[1] + o[1]), p, pe - st["de"])
        zn, kn = _renorm(zn)
        return p, pe, zn, kn, x + kn - st["kd"]

    def accept(ok, site, gl, two_s, p, pe, zn, kn):
        y.real[ok] -= two_s[ok, None] * w[site].real
        y.imag[ok] -= two_s[ok, None] * w[site].imag
        ur, ui, c = st["ur"][ok], st["ui"][ok], st["c"][ok]
        nx = ur * gl[ok].real - ui * gl[ok].imag
        ny = ur * gl[ok].imag + ui * gl[ok].real
        eb = _exponent_bits(np.maximum(c, np.maximum(np.abs(nx), np.abs(ny))))
        down = _down(eb)
        st["ur"][ok], st["ui"][ok], st["c"][ok] = nx * down, ny * down, c * down
        bx = ((eb >> np.uint32(23)).astype(np.int64) - 127).sum(2)
        st["dm"][ok], st["de"][ok] = p[ok], pe[ok] - 2 * bx
        st["zd"][ok], st["kd"][ok] = zn[ok], kn[ok]
        sa[ok] -= two_s[ok] * a[site]
        spins[ok, site] = -spins[ok, site]

    renew(False)
    for s0 in range(0, n_steps, n_sites):
        for t in range(s0, min(s0 + n_sites, n_steps)):
            site = sched[t % n_sites]
            sign = (spins[:, site] < 0).astype(int)
            two_s = F32(2) * spins[:, site]
            gl = lay(g[site][sign])
            p, pe, zn, kn, x = propose(gl)
            zd = st["zd"]
            f = site_tab[site, sign]
            av, ka = _renorm(f[:, 2] * zn)
            d = ka + 2 * np.rint(f[:, 3]).astype(np.int64) + x
            u = uniforms[t]
            with np.errstate(divide="ignore"):
                if n_beta > 1:
                    test = np.log2(u) * inv_beta < np.log2(av) - np.log2(zd) + d.astype(F32)
                else:
                    test = np.where(d > -126, u * zd < np.ldexp(av, np.clip(d, -125, 0)), u == 0)
            ok = (av > 0) & ((d >= 1) | test)
            accept(ok, site, gl, two_s, p, pe, zn, kn)
            n_acc += ok
        ln_re = renew(n_beta > 1)
        if n_beta > 1:
            for parity in (0, 1):
                r_ = rows % n_beta
                lower = ((r_ - parity) % 2 == 0) & (r_ >= parity) & (r_ + 1 < n_beta)
                upper = ((r_ - parity) % 2 == 1) & (r_ > parity)
                partner = np.where(lower, rows + 1, np.where(upper, rows - 1, rows))
                dl = ln_re[partner] - ln_re
                acc_lower = lower & (swap_uniforms[s0 // n_sites, parity]
                                     < np.exp(F32(2) * F32(1.0 / n_beta) * np.minimum(dl, F32(0))))
                src = np.where(acc_lower | acc_lower[partner], partner, rows)
                spins, y, sa, ln_re = spins[src], y[src], sa[src], ln_re[src]
                for key in ("ur", "ui", "c", "dm", "de", "zd", "kd"):
                    st[key] = st[key][src]
                st["dinv"] = tuple(x[src] for x in st["dinv"])

    acc = [np.zeros(k, np.complex64) for _ in range(4)]
    for i in range(n):
        sign = (spins[:, i] < 0).astype(int)
        mx, my = factors(lay(g[i][sign]))
        if narrow:  # in pairs, the product into [1, 2) after each pair
            (ax_, bx_), (ay_, by_) = pairs(mx), pairs(my, 0.0)
            px, py = np.ones((k, lay.lanes), F32), np.zeros((k, lay.lanes), F32)
            pe_ = np.zeros((k, lay.lanes), np.int64)
            for r in range(ax_.shape[-1]):
                qx, qy = _cmul(ax_[..., r], ay_[..., r], bx_[..., r], by_[..., r])
                px, py, e1 = _renorm_pair(*_cmul(px, py, qx, qy))
                pe_ += e1
        else:
            mx, my, e = _renorm_pair(mx, my)
            px, py = cprod_over_r(mx, my)
            px, py, e1 = _renorm_pair(px, py)
            pe_ = e.sum(-1) + e1
        tx, ty, te = _butterfly(lambda s_, o: cmul_e(s_, o), px, py, pe_)
        f = site_tab[i, sign]
        mx_, my_ = _cmul(f[:, 0], f[:, 1], tx, ty)
        mx_, my_ = _cmul(mx_, my_, st["dinv"][0], st["dinv"][1])
        ex = np.rint(f[:, 3]).astype(np.int64) + te + st["dinv"][2]
        with np.errstate(over="ignore", under="ignore"):
            acc[i % 4] = acc[i % 4] + (np.ldexp(mx_, ex) + 1j * np.ldexp(my_, ex)).astype(np.complex64)
    off = (acc[0] + acc[2]) + (acc[1] + acc[3])
    return spins, y, sa, n_acc, off, st["ln_factor_max"]


def _jax_reference(kind, n, h_or_alpha, p_np, spins, sched, u_flip, u_swap, n_beta):
    """The JAX package's float32 composition: the sweeps (or the tempered
    rounds and swap phases), then the off-diagonal sum of every row."""
    if kind == "RBM":
        jm = JRBM(n_inputs=n, n_hiddens=h_or_alpha, dtype=jnp.float32)
    else:
        jm = JRBMTrSymm(n_inputs=n, alpha=h_or_alpha, dtype=jnp.float32)
    jp = {name: C(jnp.asarray(v.real, np.float32), jnp.asarray(v.imag, np.float32)) for name, v in p_np.items()}
    jwork = jm.make_work(jp)
    jcache, jln = jengine.full_forward(jwork, jnp.asarray(spins, np.float32))
    n_sweeps = u_flip.shape[0] // n
    if n_beta == 1:
        jcache, jln, _ = jmetropolis._sweep_scan(jwork, jcache, jln, jnp.asarray(np.tile(sched, n_sweeps)),
                                                 jnp.asarray(u_flip))
    else:
        beta = jtempering.replica_betas(n_beta, spins.shape[0] // n_beta, jnp.float32)
        for s in range(n_sweeps):
            jcache, jln, _ = jtempering._tempered_flip_scan(jwork, jcache, jln, jnp.asarray(sched),
                                                            jnp.asarray(u_flip[s * n:(s + 1) * n]), beta)
            for parity in (0, 1):
                jcache, jln, _ = jtempering._swap_phase(jcache, jln, jnp.asarray(u_swap[s, parity]), parity, n_beta,
                                                        spins.shape[0] // n_beta)
    joff = jising._offdiag_sum(jwork, jcache, jln, n, fused=False)
    return np.asarray(jcache.spins), _np(jcache.y), _np(joff)


def _check(model, ref_spins, ref_y, ref_off, y_atol=Y_ATOL, label=""):
    """Decisions apart on at most MISMATCH_MAX of the walkers; y within
    y_atol and the off-diagonal sums within OFFDIAG_RTOL of their largest
    |value| on the others. Returns the share apart."""
    spins, y, _, _, off, _ = model
    same = (spins == ref_spins).all(1)
    share = 1.0 - same.mean()
    assert share <= MISMATCH_MAX, (label, share)
    assert np.abs(y[same] - ref_y[same]).max() <= y_atol, label
    err = np.abs(off[same] - ref_off[same]).max() / np.abs(ref_off[same]).max()
    assert err <= OFFDIAG_RTOL, (label, err)
    return share


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("n_beta", [1, 4])
@pytest.mark.parametrize("kind", ["RBM", "RBMTrSymm"])
def test_model_matches_plain_and_jax(kind, n_beta, rng):
    """Two sweeps then the off-diagonal sum of every row, at H = 40 (RBM,
    a partial second word) and H = 24 (RBMTrSymm, alpha 2), K = 2048: the
    model against the port's plain megakernel and the JAX composition, all
    float32, on shared uniforms."""
    n, k, n_sweeps = 12, 2048, 2
    shape = 40 if kind == "RBM" else 2
    tm = RBM(n_inputs=n, n_hiddens=shape, dtype=torch.float32) if kind == "RBM" else \
        RBMTrSymm(n_inputs=n, alpha=shape, dtype=torch.float32)
    jm = JRBM(n_inputs=n, n_hiddens=shape) if kind == "RBM" else JRBMTrSymm(n_inputs=n, alpha=shape)
    p_np = {name: 0.3 * (rng.normal(size=s) + 1j * rng.normal(size=s)) for name, s in jm.param_spec()}
    spins = np.where(rng.random((k, n)) < 0.5, -1.0, 1.0).astype(np.float32)
    sched = chain_checkerboard(n)
    u_flip = rng.random((n_sweeps * n, k)).astype(np.float32)
    u_swap = rng.random((n_sweeps, 2, k)).astype(np.float32)

    work = tm.make_work(params_from_jax(tm, p_np, device="cpu"))
    cache, ln = engine.full_forward(work, torch.as_tensor(spins))
    model = megakernel_model(work, cache, sched, u_flip, n_beta, u_swap)
    cp, _, acc_p, op = sweep_energy.sweeps_offdiag_plain(work, cache, ln, torch.as_tensor(sched),
                                                         torch.as_tensor(u_flip), n_beta,
                                                         torch.as_tensor(u_swap) if n_beta > 1 else None)
    _check(model, cp.spins.numpy(), cp.y.numpy(), op.numpy(), label="plain")
    assert 0 < model[3].sum() and abs(model[3].sum() - float(acc_p)) <= MISMATCH_MAX * k * n_sweeps * n
    _check(model, *_jax_reference(kind, n, shape, p_np, spins, sched, u_flip, u_swap, n_beta), label="jax")


def _widened(work, cache):
    """work and cache in complex128 and float64, the same values: the float32
    y as it is, not recomputed."""
    w64 = Work(*(None if t is None else t.to(torch.complex128) for t in work))
    c64 = engine.Cache(cache.spins.double(), cache.y.to(torch.complex128), cache.sa.to(torch.complex128))
    return w64, c64, engine.cache_log_psi(w64, c64)


@pytest.mark.parametrize("n_beta", [1, 4])
@pytest.mark.parametrize("case", F32_STRESS)
def test_model_on_stress_inputs(case, n_beta):
    """The stress inputs (N = 16, K = 512, two sweeps): the model's decisions
    and y against the plain megakernel in float64 from the same float32
    state on the same uniforms, and its off-diagonal sums against the plain
    float64 sum on its own final float32 state (the float32 y's rounding,
    about 4e-6 at |y| = 45, moves a term of "Re w 20" by up to 1e-4, as a
    sensitivity of the function, not of the arithmetic). "Re w 20" takes a
    factor's |c + u G|^2 past the float32 range, which the model (and the
    kernel) crosses by a power of two per factor."""
    n, k, n_sweeps = 16, 512, 2
    w, b, a, spins = f32_stress_inputs(case, seed=7, n=n, k=k)
    rng = np.random.default_rng(8)
    work = Work(*(torch.as_tensor(x, dtype=torch.complex64) for x in (w, b, a)))
    cache, _ = engine.full_forward(work, torch.as_tensor(spins, dtype=torch.float32))
    sched = chain_checkerboard(n)
    u_flip = rng.random((n_sweeps * n, k)).astype(np.float32)
    u_swap = rng.random((n_sweeps, 2, k)).astype(np.float32)
    model = megakernel_model(work, cache, sched, u_flip, n_beta, u_swap)
    w64, c64, ln64 = _widened(work, cache)
    cp, _, _, _ = sweep_energy.sweeps_offdiag_plain(w64, c64, ln64, torch.as_tensor(sched),
                                                    torch.as_tensor(u_flip, dtype=torch.float64), n_beta,
                                                    torch.as_tensor(u_swap, dtype=torch.float64) if n_beta > 1 else None)
    m_spins, m_y, m_sa, n_acc, off, ln_factor_max = model
    final = engine.Cache(*(torch.as_tensor(x) for x in (m_spins, m_y, m_sa)))
    _, f64, f_ln = _widened(work, final)
    want = energy_ops.offdiag_sum_plain(w64, f64, f_ln).numpy()
    ref_y = cp.y.numpy()
    _check(model, cp.spins.numpy(), ref_y, off, y_atol=Y_ATOL * np.abs(ref_y).max(), label=case)
    assert np.abs(off - want).max() <= OFFDIAG_RTOL * np.abs(want).max(), case
    assert n_acc.sum() > 0 and np.isfinite(off).all()
    if case == "Re w 20":
        assert ln_factor_max > LN_FLOAT_MAX  # a factor's |c + u G|^2 past the float32 range, unscaled


def test_sweep_table_f32_layout():
    """G[i, 0] = e^{4 w_i}, G[i, 1] = e^{-4 w_i} in complex64, the per-site
    factors m 2^k = e^{-2 s (a_i + sum_j w_ij)} with |m| in [2^-1/2, 2^1/2],
    |m|^2 beside it and k an integer, and the range class (pairs up to
    |Re w| = 5); built once per (w, a) and anew after an in-place update."""
    w, b, a, _ = f32_stress_inputs("Re w 20", seed=3, n=8, k=64)
    work = Work(*(torch.as_tensor(x, dtype=torch.complex64) for x in (w, b, a)))
    g, site, narrow = engine.sweep_table_f32(work)
    assert not narrow  # |Re w| = 20 > engine.F32_PAIR_RE_W: each factor with its own power of two
    assert g.dtype == torch.complex64 and tuple(g.shape) == (8, 2, 128)
    assert site.dtype == torch.float32 and tuple(site.shape) == (8, 2, 4)
    w64 = work.w.numpy().astype(np.complex128)
    np.testing.assert_allclose(g.numpy()[:, 0], np.exp(4.0 * w64), rtol=2e-7)
    np.testing.assert_allclose(g.numpy()[:, 1], np.exp(-4.0 * w64), rtol=2e-7)
    a_site = work.a.numpy().astype(np.complex128) + w64.sum(1)
    s = site.numpy().astype(np.float64)
    m = s[..., 0] + 1j * s[..., 1]
    assert np.all(np.abs(m) >= 2 ** -0.5 - 1e-6) and np.all(np.abs(m) <= 2 ** 0.5 + 1e-6)
    np.testing.assert_allclose(s[..., 2], np.abs(m) ** 2, rtol=2e-7)
    assert np.array_equal(s[..., 3], np.rint(s[..., 3]))
    for sign, sg in ((0, 1.0), (1, -1.0)):
        z = -2.0 * sg * a_site
        np.testing.assert_allclose(np.log(np.abs(m[:, sign])) + s[:, sign, 3] * math.log(2.0), z.real, rtol=0, atol=1e-5)
        np.testing.assert_allclose(m[:, sign] / np.abs(m[:, sign]), np.exp(1j * z.imag), rtol=0, atol=1e-6)
    assert engine.sweep_table_f32(work)[0] is g
    work.w.mul_(engine.F32_PAIR_RE_W / 20.0)  # |Re w| = 5: in pairs
    g2, _, narrow = engine.sweep_table_f32(work)
    assert g2 is not g and narrow


def test_float32_range_is_checked_once_per_weight_tensor():
    """|Re w| = 20 passes; 20.5 raises ValueError, in the range check and in
    the table's build."""
    w, b, a, _ = f32_stress_inputs("Re w 20", seed=4, n=8, k=64)
    assert np.abs(w.real).max() == engine.F32_MAX_RE_W == STRESS_RE_W
    work = Work(*(torch.as_tensor(x, dtype=torch.complex64) for x in (w, b, a)))
    engine.check_f32_range(work.w)
    engine.sweep_table_f32(work)
    past = Work(work.w * (20.5 / 20.0), work.b, work.a)
    with pytest.raises(ValueError, match="20.0"):
        engine.check_f32_range(past.w)
    with pytest.raises(ValueError, match="float32"):
        engine.sweep_table_f32(past)


def test_megakernel_wrapper_refuses_past_the_range_before_a_launch(monkeypatch):
    """With the device checks passed (stubbed here) the wrapper builds its
    table, and with it the range check, before any launch: |Re w| = 20.5
    raises ValueError and nothing launches."""
    n, k = 16, 32
    w, b, a, spins = f32_stress_inputs("Re w 20", seed=5, n=n, k=k)
    work = Work(*(torch.as_tensor(x, dtype=torch.complex64) for x in (w * (20.5 / 20.0), b, a)))
    cache, _ = engine.full_forward(work, torch.as_tensor(spins, dtype=torch.float32))
    launched = []
    monkeypatch.setattr(build, "check_inputs", lambda *args, **kw: None)
    monkeypatch.setattr(build, "launch", lambda *args: launched.append(args) or 0)
    launches = sweep_energy.sweeps_offdiag_cuda.launches
    with pytest.raises(ValueError, match=r"\|Re w\| above 20.0"):
        sweep_energy.sweeps_offdiag_cuda(work, cache, torch.as_tensor(chain_checkerboard(n)), torch.rand((n, k)))
    assert launched == [] and sweep_energy.sweeps_offdiag_cuda.launches == launches
