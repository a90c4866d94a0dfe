"""The float64 energy instance's arithmetic, on the CPU.

``csrc/energy.cu``'s float64 instance (``offdiag_kernel_f64``) runs only on
the card. ``kernel_model`` below is a float64 numpy transcription of its
per-element form: the factors c_j + u_j e^{4 s w_ij} over the table of
``engine.kernel_table_f64``, the running power of two of each product (the
RBM family), and with output weights c the logs of the factors and the
wrap of the flipped unit's phase onto the principal branch. It is held to
the JAX package's float64 ``_offdiag_sum`` (its XLA path) and to the port's
``offdiag_sum_plain`` within 1e-12 of the largest |sum|, on five machines
of the registry at parameter scale 0.4 and on the stress inputs of
``utils/f64_stress.py``. With c, walkers near the principal log-cosh's
branch cut (``energy.offdiag_near_cut``) are counted apart. The kernel
itself is held to the plain sum on the card (test_torch_gpu.py,
chip_smoke.py).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_network_quantum_state_tpu.hamiltonians.ising import _offdiag_sum as j_offdiag_sum
from neural_network_quantum_state_tpu.ops import engine as jengine
from neural_network_quantum_state_tpu.ops.cplx import C
from neural_network_quantum_state_tpu_torch.ops import energy, engine
from neural_network_quantum_state_tpu_torch.ops.engine import Work
from neural_network_quantum_state_tpu_torch.utils.f64_stress import F64_STRESS, f64_stress_inputs

from test_torch_energy import _np, _setup

LN2_HI, LN2_LO = 6.93147180369123816490e-01, 1.90821492927058770002e-10  # csrc/energy.cu
RTOL = 1e-12  # the instance's bar against the plain float64 sum (chip_smoke.py F64_ENERGY_RTOL)
NEAR_CUT_MAX = 1e-2  # with c: the largest share of walkers counted apart at the cut (BRANCH_CUT_TOL_F64)
LN_DOUBLE_MAX = math.log(np.finfo(np.float64).max)
TILE_SITES, TILE_UNITS, RENORM = engine.F64_TILE_SITES, engine.F64_TILE_UNITS, 4  # csrc/energy.cu f64::kRenorm


def _renorm(p, ex):
    """The kernel's renorm: p scaled by the power of two that brings the
    larger biased exponent of its parts to 1023 (clamped to [1, 2045])."""
    def biased(x):
        return np.where(x == 0, 0, np.frexp(x)[1] + 1022)

    eb = np.clip(np.maximum(biased(p.real), biased(p.imag)), 1, 2045)
    return np.ldexp(p.real, 1023 - eb) + 1j * np.ldexp(p.imag, 1023 - eb), ex + eb - 1023


def kernel_model(table, a_site, a_lo, c, spins, y):
    """The float64 instance's sum per walker, in its order of operations
    (its fused multiply-adds as plain products and sums). Returns (sum,
    largest ln|prod_j factor| of any (walker, site) without the running
    exponent)."""
    k, n = spins.shape
    h = y.shape[1]
    n_pass, n_tile = -(-n // TILE_SITES), -(-h // TILE_UNITS)
    hp = n_tile * TILE_UNITS
    n_g = n_pass * n_tile * 2 * TILE_UNITS * TILE_SITES
    g = table[:2 * n_g].view(np.complex128).reshape(n_pass, n_tile, 2, TILE_UNITS, TILE_SITES)
    wim = None if c is None else table[2 * n_g:].reshape(n_pass, n_tile, TILE_UNITS, TILE_SITES)
    # the walker's state per unit (padding: u = 0, c = 1, c_j = 0)
    x, v = y.real, y.imag
    ax, pos = np.abs(x), x >= 0
    e = np.exp(-2.0 * ax)
    sv, cv = np.sin(v), np.cos(v)
    u, cc = np.zeros((k, hp), complex), np.ones((k, hp))
    u[:, :h] = np.where(pos, e, 1.0) * ((cv - sv) * (cv + sv) - 2j * sv * cv)
    cc[:, :h] = np.where(pos, 1.0, e)
    p, q = (1.0 + e) * cv, np.where(pos, -1.0, 1.0) * np.expm1(-2.0 * ax) * sv
    if c is None:  # prod_j D_j with its power of two
        dm, dex = np.ones(k, complex), np.zeros(k, int)
        for j in range(h):
            dm, dex = _renorm(dm * ((p[:, j] + 1j * q[:, j]) * (cv[:, j] - 1j * sv[:, j])), dex)
    else:  # sum_j c_j (-ln|D_j| - i Arg cosh y_j)
        walker_term = (c * (-0.5 * np.log(p * p + q * q) - 1j * np.arctan2(q, p))).sum(1)
        vred = np.zeros((k, hp))
        vred[:, :h] = v - 2.0 * math.pi * np.rint(v / (2.0 * math.pi))
        cpad = np.zeros(hp, complex)
        cpad[:h] = c
    total, ln_unscaled = np.zeros(k, complex), -np.inf
    lanes = np.arange(TILE_SITES)
    for pas in range(n_pass):
        sites = pas * TILE_SITES + lanes
        valid = sites < n
        s = np.ones((k, TILE_SITES))
        s[:, valid] = spins[:, sites[valid]]
        orient = (s < 0).astype(int)
        acc = np.zeros((k, TILE_SITES), complex) if c is not None else np.ones((k, TILE_SITES), complex)
        ex, ln_m = np.zeros((k, TILE_SITES), int), np.zeros((k, TILE_SITES))
        for t in range(n_tile):
            for jj in range(TILE_UNITS):
                j = t * TILE_UNITS + jj
                m = u[:, j, None] * g[pas, t, orient, jj, lanes[None, :]] + cc[:, j, None]
                ln_m += np.log(np.abs(m))
                if c is None:
                    acc = acc * m
                    if jj % RENORM == RENORM - 1:
                        acc, ex = _renorm(acc, ex)
                else:
                    ph = vred[:, j, None] - 2.0 * s * wim[pas, t, jj][None, :] + np.angle(m)
                    ph -= 2.0 * math.pi * np.rint(ph / (2.0 * math.pi))
                    acc = acc + cpad[j] * (0.5 * np.log(np.abs(m) ** 2) + 1j * ph)
        z = -2.0 * s[:, valid] * a_site[sites[valid]][None, :]
        z_lo = -2.0 * s[:, valid] * a_lo[sites[valid]][None, :]
        if c is None:  # -2 s Re a' and k ln 2 first (ln 2 in two parts), then a''s rounding error
            kk = (ex[:, valid] - dex[:, None]).astype(float)
            zr = ((z.real + kk * LN2_HI) + kk * LN2_LO) + z_lo.real
            ratio = acc[:, valid] / dm[:, None] * np.exp(zr + 1j * (z.imag + z_lo.imag))
        else:
            ratio = np.exp(acc[:, valid] + walker_term[:, None] + z + z_lo)
        total += ratio.sum(1)
        ln_unscaled = max(ln_unscaled, float(ln_m[:, valid].max()))
    return total, ln_unscaled


def _model(work, cache):
    table, a_site, a_lo = engine.kernel_table_f64(work)
    c = None if work.c is None else work.c.numpy()
    return kernel_model(table.numpy(), a_site.numpy(), a_lo.numpy(), c, cache.spins.numpy(), cache.y.numpy())


def _jax_work(w, b, a, c):
    def cp(x):
        return None if x is None else C(jnp.asarray(x.real), jnp.asarray(x.imag))

    return jengine.Work(w=cp(w), b=cp(b), a=cp(a), c=cp(c))


def _check(got, *wants, near=None):
    """max|got - want| / max|want| <= RTOL for each reference, over the
    walkers away from the branch cut (near: (K,) bool, or None)."""
    far = np.ones(got.shape[0], bool) if near is None else ~near
    for want in wants:
        rel = np.abs(got - want)[far].max() / np.abs(want[far]).max()
        assert rel <= RTOL, rel


def _near(work, cache):
    if work.c is None:
        return None
    near = energy.offdiag_near_cut(work, cache).numpy()
    assert near.mean() <= NEAR_CUT_MAX
    return near


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("kind", ["RBMTrSymm", "RBM", "RBMZ2PrSymm", "FFNN", "FFNNTrSymm"])
@pytest.mark.parametrize("n", [16, 72])
def test_model_matches_jax_and_plain_on_machines(kind, n, rng):
    """Five machines at parameter scale 0.4: one pass of sites (N = 16) and
    two (N = 72, the second partly padding)."""
    (jwork, jcache, jln), (work, cache, ln) = _setup(kind, n, 48, rng)
    got, _ = _model(work, cache)
    want_jax = _np(j_offdiag_sum(jwork, jcache, jln, n, fused=False))
    want_plain = energy.offdiag_sum_plain(work, cache, ln).numpy()
    _check(got, want_jax, want_plain, near=_near(work, cache))


@pytest.mark.parametrize("has_c", [False, True], ids=["rbm", "with_c"])
@pytest.mark.parametrize("case", F64_STRESS)
def test_model_matches_jax_and_plain_on_stress_inputs(case, has_c):
    w, b, a, c, spins = f64_stress_inputs(case, has_c, seed=7)
    jwork = _jax_work(w, b, a, c)
    jcache, jln = jengine.full_forward(jwork, jnp.asarray(spins))
    work = Work(*(None if x is None else torch.as_tensor(x) for x in (w, b, a, c)))
    cache, ln = engine.full_forward(work, torch.as_tensor(spins))
    got, ln_unscaled = _model(work, cache)
    want_jax = _np(j_offdiag_sum(jwork, jcache, jln, spins.shape[1], fused=False))
    want_plain = energy.offdiag_sum_plain(work, cache, ln).numpy()
    assert np.isfinite(want_plain).all()
    _check(got, want_jax, want_plain, near=_near(work, cache))
    if case == "overflow":  # the products leave the double range without the running exponent
        assert ln_unscaled > LN_DOUBLE_MAX
    if case == "near a zero of cosh":  # |cosh y| <= 1.5e-3 at the chosen units
        assert (np.abs(np.cosh(cache.y[:4].numpy())).min(1) < 1.5e-3).all()
    if case == "large Re w":
        assert (np.abs(w.real) >= 2.0).sum() >= w.size // 32


@pytest.mark.parametrize("has_c", [False, True], ids=["rbm", "with_c"])
def test_kernel_table_f64_layout_and_memo(has_c):
    """The table's tiles and the shifted a, built apart from the float32
    table's memo, which the float64 table leaves as it is."""
    w, b, a, c, _ = f64_stress_inputs("large Re w", has_c, seed=3, n=70)
    work = Work(*(None if x is None else torch.as_tensor(x) for x in (w, b, a, c)))
    f32_memo = dict(engine.memo("kernel_table"))  # device -> this thread's float32 table memo entry
    table, a_site, a_lo = engine.kernel_table_f64(work)
    assert engine.memo("kernel_table").keys() == f32_memo.keys()
    assert all(engine.memo("kernel_table")[d] is entry for d, entry in f32_memo.items())
    n, h = w.shape
    n_pass, n_tile = -(-n // TILE_SITES), -(-h // TILE_UNITS)
    n_g = n_pass * n_tile * 2 * TILE_UNITS * TILE_SITES
    assert table.shape == (2 * n_g + (n_g // 2 if has_c else 0),)
    g = table[:2 * n_g].numpy().view(np.complex128).reshape(n_pass, n_tile, 2, TILE_UNITS, TILE_SITES)
    for i, j in ((0, 0), (5, 17), (n - 1, h - 1), (65, 40)):
        p_, l_, t_, u_ = i // TILE_SITES, i % TILE_SITES, j // TILE_UNITS, j % TILE_UNITS
        np.testing.assert_allclose(g[p_, t_, :, u_, l_], [np.exp(4.0 * w[i, j]), np.exp(-4.0 * w[i, j])], rtol=1e-15)
        if has_c:
            wim = table[2 * n_g:].numpy().reshape(n_pass, n_tile, TILE_UNITS, TILE_SITES)
            assert wim[p_, t_, u_, l_] == w[i, j].imag
    assert (g[-1, :, :, :, n % TILE_SITES:] == 1.0).all()  # padded sites: w = 0
    shift = w.real @ c if has_c else w.sum(1)
    np.testing.assert_allclose(a_site.numpy(), (0.0 if a is None else a) + shift, rtol=1e-13)
    for part in ("real", "imag"):  # the rounding error of a', at most half an ulp of it
        hi, lo = getattr(a_site.numpy(), part), getattr(a_lo.numpy(), part)
        assert (np.abs(lo) <= 0.5 * np.spacing(np.abs(hi))).all() and (hi + lo == hi).all()
