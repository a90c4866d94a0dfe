"""PyTorch port vs the JAX package: the increment-trick Renyi estimator
(``measurements/renyi_increment.py``).

Deterministic parity in float64 (1e-10) on the same numpy spins, region
masks and uniforms: ``init_glued``, one ``_propose`` (with and without a
ladder's betas), ``_glued_swap_phase``, whole sweeps (tempered and not)
against a loop of the JAX package's own ``_propose`` and
``_glued_swap_phase`` on the same uniforms (the port's ``glued_sweep``
takes its draws from the caller), both increment observables, and the
Z2-quadrature swap base's per-iteration body.

Statistics: the exact-enumeration cases of the JAX package's
tests/test_measurements.py for the increment trick at its bars (never
bitwise: the two packages' random streams differ), the glue invariants
after sweeps, and a chunked run against an unchunked one from one seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_network_quantum_state_tpu.measurements import renyi_increment as jri
from neural_network_quantum_state_tpu.measurements import sampler as jsampler
from neural_network_quantum_state_tpu.models import RBM as JRBM
from neural_network_quantum_state_tpu.ops import engine as jengine
from neural_network_quantum_state_tpu.ops.cplx import C
from neural_network_quantum_state_tpu.sampler.tempering import replica_betas as jreplica_betas
from neural_network_quantum_state_tpu_torch.measurements import AmplitudeSampler, renyi2_increment
from neural_network_quantum_state_tpu_torch.measurements import renyi_increment as ri
from neural_network_quantum_state_tpu_torch.models import RBM, params_from_jax
from neural_network_quantum_state_tpu_torch.ops import engine
from neural_network_quantum_state_tpu_torch.ops.rng import make_generator, random_spins
from neural_network_quantum_state_tpu_torch.ops.sweep import replica_betas
from neural_network_quantum_state_tpu_torch.parallel import make_mesh

N = 6
ATOL = 1e-10


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(x):
    """A JAX C pair, a complex tensor or a real array as numpy."""
    if isinstance(x, C):
        return np.asarray(x.re) + 1j * np.asarray(x.im)
    return np.asarray(x)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol)


def _close_cache(got, want):
    np.testing.assert_array_equal(_np(got.spins), _np(want.spins))
    _close(got.y, want.y)
    _close(got.sa, want.sa)


def _machines(seed=4, n=N, h=10, scale=3.0):
    """RBM(n, h) in both packages, float64, the JAX package's seeded init
    parameters times `scale` (so that |psi|^2 is far from uniform)."""
    jm = JRBM(n_inputs=n, n_hiddens=h, dtype=jnp.float64)
    jp = {k: C(scale * v.re, scale * v.im) for k, v in jm.init_params(jax.random.PRNGKey(seed)).items()}
    tm = RBM(n_inputs=n, n_hiddens=h, dtype=torch.float64)
    tp = params_from_jax(tm, {k: (np.asarray(v.re), np.asarray(v.im)) for k, v in jp.items()}, device="cpu")
    return jm.make_work(jp), tm.make_work(tp)


def _glued_inputs(k=32, levels=4, seed=0, n=N):
    rng = np.random.default_rng(seed)
    s1, s2 = (np.where(rng.random((k, n)) < 0.5, 1.0, -1.0) for _ in range(2))
    level = np.repeat(np.arange(levels), k // levels)
    mask = np.arange(n)[None, :] < level[:, None]
    return s1, s2, mask, level


def _both_states(jwork, twork, s1, s2, mask):
    jst = jri.init_glued(jwork, jnp.asarray(s1), jnp.asarray(s2), jnp.asarray(mask), jax.random.PRNGKey(0))
    tst = ri.init_glued(twork, torch.as_tensor(s1), torch.as_tensor(s2), torch.as_tensor(mask),
                        make_generator(0, "cpu"))
    return jst, tst


def _close_states(tst, jst):
    for tc, jc in zip(tst[:4], jst[:4]):
        _close_cache(tc, jc)
    for tl, jl in zip(tst[4:8], jst[4:8]):
        _close(tl, jl)


# ---------------------------------------------------------------------------
# Deterministic parity


def test_init_glued_matches_jax():
    jwork, twork = _machines()
    s1, s2, mask, _ = _glued_inputs()
    jst, tst = _both_states(jwork, twork, s1, s2, mask)
    _close_states(tst, jst)
    np.testing.assert_array_equal(tst.c3.spins.numpy(), np.where(mask, s1, s2))
    assert float(tst.n_accepted) == 0.0 and float(tst.n_proposed) == 0.0
    assert tst.n_proposed.dtype == torch.float64


@pytest.mark.parametrize("n_beta", [1, 4])
@pytest.mark.parametrize("site", [0, 3, 5])
def test_propose_matches_jax_on_shared_uniforms(site, n_beta):
    """One proposal on replica 1 (partners c3 in the region, c4 outside),
    on the same uniforms; with n_beta = 4 the ladder's per-walker betas."""
    jwork, twork = _machines()
    s1, s2, mask, _ = _glued_inputs()
    jst, tst = _both_states(jwork, twork, s1, s2, mask)
    u = np.random.default_rng(site).random(32)
    jbeta = jreplica_betas(n_beta, 32 // n_beta, jnp.float64) if n_beta > 1 else None
    tbeta = replica_betas(n_beta, 32 // n_beta, torch.float64) if n_beta > 1 else None
    want = jri._propose(jwork, jst.c1, jst.ln1, jst.c3, jst.ln3, jst.c4, jst.ln4, jnp.asarray(mask[:, site]),
                        site, jnp.asarray(u), jbeta)
    got = ri._propose(twork, tst.c1, tst.ln1, tst.c3, tst.ln3, tst.c4, tst.ln4, torch.as_tensor(mask[:, site]),
                      site, torch.as_tensor(u), tbeta)
    for g, w in zip(got[0:6:2], want[0:6:2]):
        _close_cache(g, w)
    for g, w in zip(got[1:6:2], want[1:6:2]):
        _close(g, w)
    np.testing.assert_array_equal(got[6].numpy(), np.asarray(want[6]))
    assert 0 < int(got[6].sum()) < 32  # both outcomes occur


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("n_beta", [2, 4])
def test_glued_swap_phase_matches_jax(parity, n_beta):
    jwork, twork = _machines()
    s1, s2, mask, _ = _glued_inputs(levels=2)
    jst, tst = _both_states(jwork, twork, s1, s2, mask)
    u = np.random.default_rng(7).random(32)
    jc, jl, jacc = jri._glued_swap_phase(jst[:4], jst[4:8], jnp.asarray(u), parity, n_beta)
    tc, tl, tacc = ri._glued_swap_phase(tst[:4], tst[4:8], torch.as_tensor(u), parity, n_beta)
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    for g, w in zip(tc, jc):
        _close_cache(g, w)
    for g, w in zip(tl, jl):
        _close(g, w)


def _jax_sweep(jwork, jst, mask, uniforms, swap_uniforms, n_beta):
    """One glued sweep of the JAX package's own steps on the given uniforms."""
    c1, c2, c3, c4 = jst[:4]
    l1, l2, l3, l4 = jst[4:8]
    k = uniforms.shape[2]
    beta = jreplica_betas(n_beta, k // n_beta, jnp.float64) if n_beta > 1 else None
    m = jnp.asarray(mask)
    for site in range(uniforms.shape[0]):
        in_reg = m[:, site]
        c1, l1, c3, l3, c4, l4, _ = jri._propose(jwork, c1, l1, c3, l3, c4, l4, in_reg, site,
                                                 jnp.asarray(uniforms[site, 0]), beta)
        c2, l2, c4, l4, c3, l3, _ = jri._propose(jwork, c2, l2, c4, l4, c3, l3, in_reg, site,
                                                 jnp.asarray(uniforms[site, 1]), beta)
    caches, lns = (c1, c2, c3, c4), (l1, l2, l3, l4)
    if n_beta > 1:
        for parity in (0, 1):
            caches, lns, _ = jri._glued_swap_phase(caches, lns, jnp.asarray(swap_uniforms[parity]), parity, n_beta)
    return (*caches, *lns)


@pytest.mark.parametrize("n_beta", [1, 4])
def test_glued_sweeps_match_jax_steps_on_shared_uniforms(n_beta):
    """Three whole sweeps of the port's glued_sweep against the JAX
    package's _propose/_glued_swap_phase loop on the same uniforms, and the
    glue invariant after them."""
    jwork, twork = _machines()
    s1, s2, mask, _ = _glued_inputs(k=32, levels=4)
    jst, tst = _both_states(jwork, twork, s1, s2, mask)
    rng = np.random.default_rng(n_beta)
    tmask = torch.as_tensor(mask)
    jstate = tuple(jst[:8])
    for _ in range(3):
        uniforms, swaps = rng.random((N, 2, 32)), rng.random((2, 32))
        jstate = _jax_sweep(jwork, jstate, mask, uniforms, swaps, n_beta)
        tst = ri.glued_sweep(twork, tst, range(N), tmask, torch.as_tensor(uniforms),
                             torch.as_tensor(swaps) if n_beta > 1 else None, n_beta)
    _close_states(tst, jstate)
    s1n, s2n = tst.c1.spins.numpy(), tst.c2.spins.numpy()
    np.testing.assert_array_equal(tst.c3.spins.numpy(), np.where(mask, s1n, s2n))
    np.testing.assert_array_equal(tst.c4.spins.numpy(), np.where(mask, s2n, s1n))
    assert float(tst.n_proposed) == 3 * 2 * N * 32 and 0 < float(tst.n_accepted) < float(tst.n_proposed)


@pytest.mark.parametrize("orbit", [False, True], ids=["plain", "z2-orbit"])
def test_increment_observables_match_jax(orbit):
    jwork, twork = _machines()
    s1, s2, mask, level = _glued_inputs(k=40, levels=5)
    jst, tst = _both_states(jwork, twork, s1, s2, mask)
    if orbit:
        want = jri._orbit_increment_observable(jwork, jst, jnp.asarray(mask), jnp.asarray(level))
        got = ri._orbit_increment_observable(twork, tst, torch.as_tensor(mask), torch.as_tensor(level))
    else:
        want = jri._increment_observable(jwork, jst, jnp.asarray(level))
        got = ri._increment_observable(twork, tst, torch.as_tensor(level))
    for g, w in zip(got, want):
        _close(g, w)


class _Stub:
    """A sampler with one fixed state (see test_torch_measurements.py)."""

    def __init__(self, work, cache, lnpsi, n):
        self.work, self.cache, self.lnpsi, self.n_inputs = work, cache, lnpsi, n
        self.device = torch.device("cpu")

    def warm_up(self, n):
        pass


@pytest.mark.parametrize("l", [1, 3])
def test_swap_base_z2_body_matches_jax(l, monkeypatch):
    jwork, twork = _machines()
    s1, s2, _, _ = _glued_inputs(k=40)
    outs = {}

    def pair(pkg):
        def run(a, b, accum, n_iterations, n_sweeps=1, chunk=None):
            out = accum(a.cache, a.lnpsi, b.cache, b.lnpsi)
            outs[pkg] = [np.asarray(x) for x in out]
            return tuple(np.repeat(np.asarray(x)[None], 2, 0) for x in out)

        return run

    monkeypatch.setattr(jsampler, "run_pair_estimator", pair("jax"))
    monkeypatch.setattr(ri, "run_pair_estimator", pair("torch"))
    jstubs = [_Stub(jwork, *jengine.full_forward(jwork, jnp.asarray(s)), N) for s in (s1, s2)]
    tstubs = [_Stub(twork, *engine.full_forward(twork, torch.as_tensor(s)), N) for s in (s1, s2)]
    want = jri.swap_base_z2(*jstubs, l, 2)
    got = ri.swap_base_z2(*tstubs, l, 2)
    for g, w in zip(outs["torch"], outs["jax"]):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
    assert got[0] == pytest.approx(want[0], abs=ATOL)


# ---------------------------------------------------------------------------
# Statistics and the sampler


def _machine(seed, n=N, h=10):
    m = RBM(n_inputs=n, n_hiddens=h, dtype=torch.float64)
    return m, m.init_params(make_generator(seed, "cpu"))


def _exact_s2(machine, params, l, n=N):
    idx = np.arange(2**n)
    spins = 1.0 - 2.0 * ((idx[:, None] >> np.arange(n)[None, :]) & 1)
    psi = np.exp(engine.log_psi(machine.make_work(params), torch.as_tensor(spins)).numpy())
    psi = psi / np.linalg.norm(psi)
    psi_mat = psi.reshape(2 ** (n - l), 2**l)
    rho_a = psi_mat.T @ psi_mat.conj()
    return -np.log(np.real(np.trace(rho_a @ rho_a)))


@pytest.mark.parametrize("z2q", [False, True], ids=["plain", "z2q"])
def test_renyi2_increment_vs_exact(z2q):
    m1, p1 = _machine(2)
    s2_exact = _exact_s2(m1, p1, 3)
    got, err, per_level = renyi2_increment(m1, p1, 3, n_iterations=40, n_sweeps=2, n_warmup=100,
                                           walkers_per_level=512, key=11, z2_quadrature=z2q, device="cpu")
    assert per_level.shape == (3, 3)
    assert abs(got - s2_exact) < max(5 * err, 0.05), (got, s2_exact, err)


def test_renyi2_increment_hybrid_offset():
    """level_offset + the exact base -ln q_1 = the full S2 (the -l0 path),
    from Neel starts."""
    m1, p1 = _machine(2)
    neel = np.where(np.arange(N) % 2 == 0, 1.0, -1.0)
    got, err, per_level = renyi2_increment(m1, p1, 3, n_iterations=40, n_sweeps=2, n_warmup=100,
                                           walkers_per_level=512, key=12, level_offset=1,
                                           init_spins=(neel, neel), device="cpu")
    assert per_level.shape == (2, 3)
    total = _exact_s2(m1, p1, 1) + got
    assert abs(total - _exact_s2(m1, p1, 3)) < max(5 * err, 0.05), (total, err)


def test_renyi2_increment_pt_ladder_vs_exact():
    """n_beta > 1 (the glued PT ladder): the beta=1 readout still estimates
    the exact S2."""
    m1, p1 = _machine(2)
    got, err, per_level = renyi2_increment(m1, p1, 3, n_iterations=40, n_sweeps=2, n_warmup=60,
                                           walkers_per_level=512, key=13, n_beta=4, device="cpu")
    assert per_level.shape == (3, 3)
    assert abs(got - _exact_s2(m1, p1, 3)) < max(5 * err, 0.05), (got, err)


def _cat_machine(c=2.0, asym=0.05):
    """The JAX package's hand-built sector-asymmetric cat: ln psi =
    asym * sum (-1)^i s_i + logcosh(c * sum (-1)^i s_i)."""
    m = RBM(n_inputs=N, n_hiddens=10, dtype=torch.float64)
    stag = torch.as_tensor(np.where(np.arange(N) % 2 == 0, 1.0, -1.0))
    w = torch.zeros((N, 10), dtype=torch.complex128)
    w[:, 0] = c * stag
    return m, {"w": w, "a": (asym * stag).to(torch.complex128), "b": torch.zeros(10, dtype=torch.complex128)}


def test_renyi2_increment_z2q_rescues_frozen_sector():
    """On a deep-ordered asymmetric cat with both replicas frozen in one
    Neel sector the plain increment chain is biased, while the Z2 orbit
    quadrature recovers the exact cat entropy."""
    m1, p1 = _cat_machine()
    s2_exact = _exact_s2(m1, p1, 3)
    assert s2_exact > 0.3
    neel = np.where(np.arange(N) % 2 == 0, 1.0, -1.0)
    kwargs = dict(n_iterations=40, n_sweeps=2, n_warmup=60, walkers_per_level=256, key=7,
                  init_spins=(neel, neel), device="cpu")
    plain, _, _ = renyi2_increment(m1, p1, 3, **kwargs)
    rb, rb_err, _ = renyi2_increment(m1, p1, 3, z2_quadrature=True, **kwargs)
    assert abs(plain - s2_exact) > 0.1, (plain, s2_exact)  # frozen bias
    assert abs(rb - s2_exact) < max(5 * rb_err, 0.05), (rb, s2_exact, rb_err)


@pytest.mark.parametrize("l", [1, 3])
def test_swap_base_z2_vs_exact(l):
    m1, p1 = _machine(2)
    s1 = AmplitudeSampler(m1, p1, n_walkers=1024, key=31 + l, device="cpu")
    s2 = AmplitudeSampler(m1, p1, n_walkers=1024, key=77 + l, device="cpu")
    got, err = ri.swap_base_z2(s1, s2, l, n_iterations=40, n_sweeps=2, n_warmup=120)
    want = _exact_s2(m1, p1, l)
    assert abs(got - want) < max(6 * err, 0.05), (l, got, want, err)


@pytest.mark.parametrize("n_beta", [1, 4])
def test_glued_sweeps_keep_the_glue_and_exact_caches(n_beta):
    """After sweeps on the generator's draws: s3 == glue(s1, s2),
    s4 == glue(s2, s1) on every replica, the incremental ln psi equal to
    from-scratch forwards, and the counters float64."""
    m1, p1 = _machine(4)
    work = m1.make_work(p1)
    g = make_generator(0, "cpu")
    k = 32
    level = torch.arange(4).repeat_interleave(8)  # n_beta = 4: 2 chains x 4 replicas a level
    mask = torch.arange(N)[None, :] < level[:, None]
    st = ri.init_glued(work, random_spins(g, k, N, torch.float64), random_spins(g, k, N, torch.float64), mask, g)
    st = ri.glued_sweeps(work, st, np.arange(N), mask, 5, n_beta)
    s1n, s2n = st.c1.spins.numpy(), st.c2.spins.numpy()
    np.testing.assert_array_equal(st.c3.spins.numpy(), np.where(mask.numpy(), s1n, s2n))
    np.testing.assert_array_equal(st.c4.spins.numpy(), np.where(mask.numpy(), s2n, s1n))
    for c, ln in zip(st[:4], st[4:8]):
        _close(ln, engine.log_psi(work, c.spins), atol=1e-9)
    assert float(st.n_proposed) == 2 * 5 * N * k and float(st.n_accepted) > 0
    assert st.n_accepted.dtype == torch.float64


def test_renyi2_increment_chunked_matches_unchunked():
    """The chunk bound changes only when outputs are copied to the host:
    chunked and unchunked runs from one seed give the same estimate."""
    m1, p1 = _machine(6)
    kwargs = dict(n_iterations=12, n_warmup=20, walkers_per_level=64, key=3, device="cpu")
    mono = renyi2_increment(m1, p1, 2, **kwargs)
    chunked = renyi2_increment(m1, p1, 2, chunk=5, **kwargs)
    assert np.isfinite(mono[0])
    assert mono[:2] == chunked[:2]
    np.testing.assert_array_equal(mono[2], chunked[2])


def test_renyi2_increment_refuses_what_the_jax_package_refuses():
    m1, p1 = _machine(0)
    with pytest.raises(ValueError, match="level_offset"):
        renyi2_increment(m1, p1, N, 2, device="cpu")
    with pytest.raises(ValueError, match="multiple of n_beta"):
        renyi2_increment(m1, p1, 2, 2, walkers_per_level=6, n_beta=4, device="cpu")
    with pytest.raises(ValueError, match="whole replica groups"):  # meshes: tests/test_torch_mesh_drivers.py
        renyi2_increment(m1, p1, 2, 2, walkers_per_level=6, n_beta=2, mesh=make_mesh(4, device="cpu"))
    kw = dict(n_iterations=2, n_warmup=2, walkers_per_level=8, n_blocks=2, key=3)
    one = renyi2_increment(m1, p1, 2, device="cpu", **kw)
    two = renyi2_increment(m1, p1, 2, mesh=make_mesh(2, device="cpu"), **kw)
    np.testing.assert_allclose(two[2], one[2], rtol=0, atol=1e-12)  # a mesh makes one device's chains
