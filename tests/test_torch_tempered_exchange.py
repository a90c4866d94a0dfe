"""PyTorch port vs the JAX package: parallel-tempered Kawasaki exchange.

The plain tempered exchange (``ops/exchange.py::tempered_exchange_plain``,
the twin of the exchange kernel's tempered instance) is held to the JAX
package's ``kawasaki._exchange_scan(..., beta=)`` and
``tempering._swap_phase`` decision for decision on the same numpy uniforms
in float64; the sampler (``sampler/kawasaki.py::tempered_exchange_sweeps``)
to the cases of the JAX package's tests/test_tempered_exchange.py: the
sectors and the cache kept per replica, the beta = 1 slice against the
sector |psi|^2 by chi^2 (never bitwise: the two packages' streams differ),
the untempered sampler, the ladder probe and tune, and tempered VMC against
the sector's exact ground state. The kernel itself is held to the plain
twin on the card (test_torch_gpu.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_network_quantum_state_tpu.models import RBM as JRBM
from neural_network_quantum_state_tpu.ops import engine as jengine
from neural_network_quantum_state_tpu.ops.cplx import C
from neural_network_quantum_state_tpu.sampler import kawasaki as jkawasaki
from neural_network_quantum_state_tpu.sampler import tempering as jtempering
from neural_network_quantum_state_tpu.utils.exact import ground_energy, hubbard_chain_dense, sector_restrict
from neural_network_quantum_state_tpu.utils.exact import spins_to_index
from neural_network_quantum_state_tpu_torch import VMC, VMCConfig
from neural_network_quantum_state_tpu_torch.hamiltonians import HubbardChain
from neural_network_quantum_state_tpu_torch.models import RBM, params_from_jax
from neural_network_quantum_state_tpu_torch.ops import engine
from neural_network_quantum_state_tpu_torch.ops import exchange as exchange_ops
from neural_network_quantum_state_tpu_torch.ops.rng import ExchangeDraws, make_generator, philox_key
from neural_network_quantum_state_tpu_torch.ops.sweep import replica_betas, swap_phase
from neural_network_quantum_state_tpu_torch.sampler import init_state, kawasaki

L = 3  # 6 JW spins, as the JAX package's tests


def _np(c):
    return np.asarray(c.re) + 1j * np.asarray(c.im)


def _t(x):
    return torch.as_tensor(np.asarray(x))


# The JAX package's functions, jitted here so that the cases of one shape
# share one compilation.
_jax_exchange_scan = jax.jit(lambda work, cache, ln, bonds, u_sel, u_acc, beta: jkawasaki._exchange_scan(
    work, cache, ln, bonds, u_sel, u_acc, beta=beta))
_jax_swap_phase = jax.jit(jtempering._swap_phase, static_argnums=(3, 4, 5))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _sector_spins(rng, k, l, n_up, n_down):
    out = -np.ones((k, 2 * l))
    for w in range(k):
        out[w, rng.permutation(l)[:n_up]] = 1.0
        out[w, l + rng.permutation(l)[:n_down]] = 1.0
    return out


def _machine(n, h, seed, dtype=torch.float64, scale=None):
    """A port RBM with its init parameters from a seeded generator (times
    `scale` where given, to move |psi|^2 away from uniform)."""
    m = RBM(n_inputs=n, n_hiddens=h, dtype=dtype)
    params = m.init_params(make_generator(seed, "cpu"))
    if scale is not None:
        params = {name: scale * v for name, v in params.items()}
    return m, m.make_work(params)


def _state(work, ham, k, seed, dtype=torch.float64):
    g = make_generator(seed, "cpu")
    return init_state(work, ham.init_spins(g, k, dtype), make_generator(seed + 1, "cpu"))


@pytest.mark.parametrize("n_beta", [2, 3, 4])
@pytest.mark.parametrize("per_flavor_rings", [True, False], ids=["two-rings", "one-ring"])
def test_plain_tempered_exchange_matches_jax_decision_for_decision(per_flavor_rings, n_beta, rng):
    """Three sweeps of beta-scaled exchange proposals + even + odd swap
    phases on shared uniforms, float64: the same spins, y/sa/ln psi within
    1e-10, the same accepted proposals per row and the same accepted lower
    swaps per row; exchange_plain(beta=) alone returns the JAX per-walker
    counts."""
    l, h, k, n_sweeps = 4, 10, 48, 3
    n, kb = 2 * l, k // n_beta
    n_unit = n
    jm, tm = JRBM(n_inputs=n, n_hiddens=h, dtype=jnp.float64), RBM(n_inputs=n, n_hiddens=h, dtype=torch.float64)
    p_np = {name: 0.4 * (rng.normal(size=s) + 1j * rng.normal(size=s)) for name, s in jm.param_spec()}
    jp = {name: C(jnp.asarray(v.real), jnp.asarray(v.imag)) for name, v in p_np.items()}
    ham = HubbardChain(n_sites=n, n_up=2, n_down=3, per_flavor_rings=per_flavor_rings)
    spins = _sector_spins(rng, k, l, 2, 3)
    u_sel, u_acc = rng.random((n_sweeps * n_unit, k)), rng.random((n_sweeps * n_unit, k))
    u_swap = rng.random((n_sweeps, 2, k))

    jwork = jm.make_work(jp)
    jcache, jln = jengine.full_forward(jwork, jnp.asarray(spins))
    jbonds = jnp.asarray(ham.bonds)
    beta = jtempering.replica_betas(n_beta, kb, jnp.float64)
    jex, jswap = np.zeros(k), np.zeros(k)
    for s in range(n_sweeps):
        span = slice(s * n_unit, (s + 1) * n_unit)
        jcache, jln, n_acc = _jax_exchange_scan(jwork, jcache, jln, jbonds, jnp.asarray(u_sel[span]),
                                                jnp.asarray(u_acc[span]), beta)
        jex += np.asarray(n_acc)
        for parity in (0, 1):
            jcache, jln, acc_lower = _jax_swap_phase(jcache, jln, jnp.asarray(u_swap[s, parity]), parity, n_beta, kb)
            jswap += np.asarray(acc_lower)

    work = tm.make_work(params_from_jax(tm, p_np, device="cpu"))
    cache, ln = engine.full_forward(work, _t(spins))
    bonds = _t(ham.bonds)
    c2, l2, rows = exchange_ops.tempered_exchange_plain(work, cache, ln, bonds, _t(u_sel), _t(u_acc), n_beta, n_unit,
                                                        _t(u_swap))
    np.testing.assert_array_equal(c2.spins.numpy(), np.asarray(jcache.spins))
    np.testing.assert_allclose(c2.y.numpy(), _np(jcache.y), rtol=0, atol=1e-10)
    np.testing.assert_allclose(c2.sa.numpy(), _np(jcache.sa), rtol=0, atol=1e-10)
    np.testing.assert_allclose(l2.numpy(), _np(jln), rtol=0, atol=1e-10)
    np.testing.assert_array_equal(rows[0].numpy(), jex)
    np.testing.assert_array_equal(rows[1].numpy(), jswap)
    assert 0 < jswap.sum() < n_sweeps * kb * (n_beta - 1)  # some swaps taken, some refused
    _, _, counts = exchange_ops.exchange_steps(work, cache, ln, bonds, _t(u_sel), _t(u_acc), n_beta, n_unit, _t(u_swap))
    assert torch.equal(counts, rows)

    # the building blocks, composed as the JAX package composes them
    c3, l3 = cache, ln
    beta_t = replica_betas(n_beta, kb, torch.float64)
    jc1, _, jacc1 = _jax_exchange_scan(jwork, *jengine.full_forward(jwork, jnp.asarray(spins)), jbonds,
                                       jnp.asarray(u_sel[:n_unit]), jnp.asarray(u_acc[:n_unit]), beta)
    for s in range(n_sweeps):
        span = slice(s * n_unit, (s + 1) * n_unit)
        c3, l3, acc = exchange_ops.exchange_plain(work, c3, l3, bonds, _t(u_sel[span]), _t(u_acc[span]), beta=beta_t)
        if s == 0:
            assert acc.shape == (k,) and acc.dtype == torch.float64
            np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc1))
            np.testing.assert_array_equal(c3.spins.numpy(), np.asarray(jc1.spins))
        for parity in (0, 1):
            c3, l3, _ = swap_phase(c3, l3, _t(u_swap[s, parity]), parity, n_beta)
    assert torch.equal(c3.spins, c2.spins) and torch.equal(c3.y, c2.y) and torch.equal(l3, l2)


def test_plain_tempered_exchange_on_philox_draws_equals_its_tensors():
    """The plain twin given an ExchangeDraws makes the selection, acceptance
    and swap uniforms of the kernel's streams: the same result as on the
    three tensors the draws stand for."""
    n_beta, kb, n_sweeps = 4, 8, 3
    m, work = _machine(2 * L, 8, 3, torch.float32, scale=10.0)
    ham = HubbardChain(n_sites=2 * L, n_up=1, n_down=2)
    state = _state(work, ham, n_beta * kb, 4, torch.float32)
    k, n_unit = n_beta * kb, ham.n_unit_steps
    draws = ExchangeDraws(philox_key(make_generator(5, "cpu")), n_sweeps * n_unit)
    bonds = _t(ham.bonds)
    got = exchange_ops.tempered_exchange_plain(work, state.cache, state.lnpsi, bonds, draws, None, n_beta, n_unit)
    want = exchange_ops.tempered_exchange_plain(work, state.cache, state.lnpsi, bonds, draws.selection(k),
                                                draws.acceptance(k), n_beta, n_unit, draws.swaps(n_sweeps, k))
    assert torch.equal(got[0].spins, want[0].spins) and torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert float(got[2][0].sum()) > 0 and float(got[2][1].sum()) > 0
    sw = draws.swaps(n_sweeps, k)
    assert tuple(sw.shape) == (n_sweeps, 2, k) and not torch.equal(sw[0, 0], sw[0, 1])


def test_tempered_exchange_refuses_a_bad_layout():
    m, work = _machine(2 * L, 4, 0)
    ham = HubbardChain(n_sites=2 * L, n_up=1, n_down=1)
    k, n_unit = 12, ham.n_unit_steps
    cache, ln = engine.full_forward(work, ham.init_spins(make_generator(1, "cpu"), k, torch.float64))
    bonds = _t(ham.bonds)
    u = torch.rand((2 * n_unit, k), dtype=torch.float64)
    swaps = torch.rand((2, 2, k), dtype=torch.float64)
    with pytest.raises(ValueError, match="multiple of n_beta"):
        exchange_ops.exchange_steps(work, cache, ln, bonds, u, u, 5, n_unit, swaps)
    with pytest.raises(ValueError, match="whole sweeps"):
        exchange_ops.exchange_steps(work, cache, ln, bonds, u[:-1], u[:-1], 4, n_unit, swaps)
    with pytest.raises(ValueError, match="swap uniforms"):
        exchange_ops.exchange_steps(work, cache, ln, bonds, u, u, 4, n_unit, None)
    draws = ExchangeDraws(philox_key(make_generator(2, "cpu")), 2 * n_unit)
    with pytest.raises(ValueError, match="from the stream"):
        exchange_ops.exchange_steps(work, cache, ln, bonds, draws, None, 4, n_unit, swaps)
    st = init_state(work, cache.spins, make_generator(3, "cpu"))
    with pytest.raises(ValueError, match="multiple of n_beta"):
        kawasaki.tempered_exchange_sweeps(work, st, bonds, 2, n_unit, 5)


def test_sector_and_cache_conserved_per_replica():
    """Every replica of every chain keeps (n_up, n_down), and ln psi stays
    consistent with the spins through tempered sweeps + swaps (the JAX
    package's test_tempered_exchange.py:42)."""
    n_beta, kb = 4, 16
    m, work = _machine(2 * L, 8, 2)
    ham = HubbardChain(n_sites=2 * L, u=4.0, t=1.0, n_up=2, n_down=1, pbc=True)
    state = _state(work, ham, n_beta * kb, 7)
    state = kawasaki.tempered_exchange_sweeps(work, state, _t(ham.bonds), 15, ham.n_unit_steps, n_beta)
    s = state.cache.spins.numpy()
    assert np.all(((1 + s[:, :L]) / 2).sum(axis=1) == 2)  # all replicas
    assert np.all(((1 + s[:, L:]) / 2).sum(axis=1) == 1)
    _, ln_ref = engine.full_forward(work, state.cache.spins)
    np.testing.assert_allclose(state.lnpsi.numpy(), ln_ref.numpy(), rtol=1e-9)
    assert float(state.n_accepted) > 0
    assert float(state.n_proposed) == 15 * ham.n_unit_steps * n_beta * kb


def test_beta1_slice_reproduces_sector_psi_squared():
    """chi^2-style histogram test (the JAX package's :64, its sizes and
    bar): the beta = 1 replicas sample the sector-restricted |psi|^2; the
    hot replicas do not contaminate the readout slice."""
    n_in = 2 * L
    n_beta, kb = 4, 1024
    m, work = _machine(n_in, 8, 3, scale=10.0)
    ham = HubbardChain(n_sites=n_in, u=4.0, t=1.0, n_up=1, n_down=1, pbc=True)
    state = _state(work, ham, n_beta * kb, 11)
    bonds = _t(ham.bonds)

    idx = np.arange(2**n_in)
    bits = (idx[:, None] >> np.arange(n_in)[None, :]) & 1
    s_all = 1.0 - 2.0 * bits
    occ = (1 + s_all) / 2
    sector = (occ[:, :L].sum(1) == 1) & (occ[:, L:].sum(1) == 1)
    p_exact = np.exp(2 * engine.log_psi(work, _t(s_all)).real.numpy())
    p_exact = np.where(sector, p_exact, 0.0)
    p_exact /= p_exact.sum()
    assert p_exact[sector].max() > 2 * p_exact[sector].min()  # the target is far from uniform

    state = kawasaki.tempered_exchange_sweeps(work, state, bonds, 100, ham.n_unit_steps, n_beta)
    counts = np.zeros(2**n_in)
    n_samples = 0
    for _ in range(4):
        state = kawasaki.tempered_exchange_sweeps(work, state, bonds, 20, ham.n_unit_steps, n_beta)
        b1 = state.cache.spins.numpy()[::n_beta]  # beta = 1 replicas
        counts += np.bincount(spins_to_index(b1), minlength=2**n_in)
        n_samples += kb
    assert counts[~sector].sum() == 0  # never leaves the sector
    p_emp = counts / n_samples
    err = np.abs(p_emp - p_exact)
    tol = 5.0 * np.sqrt(p_exact / n_samples) + 4e-3
    assert np.all(err < tol), (p_emp[sector], p_exact[sector], err[sector], tol[sector])


def test_nbeta1_is_the_plain_exchange_sampler():
    """n_beta = 1 has no ladder: the tempered sampler draws no swap blocks
    and takes the untempered sampler's numbers on the same generator."""
    m, work = _machine(2 * L, 8, 4, scale=5.0)
    ham = HubbardChain(n_sites=2 * L, n_up=1, n_down=1)
    bonds = _t(ham.bonds)
    a = kawasaki.tempered_exchange_sweeps(work, _state(work, ham, 64, 9), bonds, 5, ham.n_unit_steps, 1)
    b = kawasaki.exchange_sweeps(work, _state(work, ham, 64, 9), bonds, 5, ham.n_unit_steps)
    assert torch.equal(a.cache.spins, b.cache.spins) and torch.equal(a.lnpsi, b.lnpsi)
    assert float(a.n_accepted) == float(b.n_accepted) > 0 and float(a.n_proposed) == float(b.n_proposed)
    st = _state(work, ham, 64, 9)
    assert kawasaki.tempered_exchange_sweeps(work, st, bonds, 0, ham.n_unit_steps, 4) is st  # the no-op


def test_tempered_density_profile_matches_the_plain_sampler():
    """The beta = 1 slice of the tempered sampler (n_beta = 4) and the
    untempered sampler give the same site occupations within Monte-Carlo
    error, both summing to the particle number (the JAX package's :102,
    whose FermionAmplitudeSampler is not ported: its density profile is the
    mean occupation of the beta = 1 walkers over sampling rounds)."""
    m, work = _machine(2 * L, 8, 4, scale=10.0)
    ham = HubbardChain(n_sites=2 * L, n_up=1, n_down=1)
    bonds = _t(ham.bonds)

    def profile(n_beta, k, seed):
        st = kawasaki.tempered_exchange_sweeps(work, _state(work, ham, k, seed), bonds, 40, ham.n_unit_steps, n_beta)
        occ = np.zeros(2 * L)
        for _ in range(4):
            st = kawasaki.tempered_exchange_sweeps(work, st, bonds, 2, ham.n_unit_steps, n_beta)
            occ += ((1.0 + st.cache.spins.numpy()[::n_beta]) / 2.0).mean(0)
        return occ / 4

    d1, d2 = profile(1, 1024, 5), profile(4, 4096, 6)
    assert abs(d1.sum() - 2.0) < 1e-9 and abs(d2.sum() - 2.0) < 1e-9
    np.testing.assert_allclose(d1, d2, atol=0.05)


def test_tempered_exchange_sweeps_draw_their_blocks_in_order():
    """Each CPU sweep is one plain exchange call on its own (n_unit_steps, K)
    selection and acceptance blocks, then the two (K,) swap blocks, drawn in
    turn from the state's generator."""
    n_beta, k, n_sweeps = 2, 32, 3
    m, work = _machine(2 * L, 8, 0, scale=20.0)
    ham = HubbardChain(n_sites=2 * L, n_up=2, n_down=1)
    bonds, n_unit = _t(ham.bonds), ham.n_unit_steps
    state = _state(work, ham, k, 1)
    calls = exchange_ops.exchange_plain.calls
    got = kawasaki.tempered_exchange_sweeps(work, state, bonds, n_sweeps, n_unit, n_beta)
    assert exchange_ops.exchange_plain.calls == calls + n_sweeps

    g = make_generator(2, "cpu")
    cache, ln, n_acc = state.cache, state.lnpsi, 0.0
    for _ in range(n_sweeps):
        u_sel = torch.rand((n_unit, k), generator=g, dtype=torch.float64)
        u_acc = torch.rand((n_unit, k), generator=g, dtype=torch.float64)
        swaps = torch.stack([torch.rand((k,), generator=g, dtype=torch.float64) for _ in range(2)])[None]
        cache, ln, acc = exchange_ops.tempered_exchange_plain(work, cache, ln, bonds, u_sel, u_acc, n_beta, n_unit, swaps)
        n_acc += float(acc[0].sum())
    assert torch.equal(got.cache.spins, cache.spins) and torch.equal(got.lnpsi, ln)
    assert float(got.n_accepted) == n_acc and got.n_accepted.dtype == torch.float64
    assert float(got.n_proposed) == n_sweeps * n_unit * k


def test_exchange_ladder_probe_and_tune():
    """exchange_swap_acceptance_probe returns per-pair and per-replica rates
    in [0, 1] that mix at near-random parameters, and tune_n_beta_exchange
    picks a ladder that divides the walkers (the JAX package's :116)."""
    m, work = _machine(2 * L, 8, 5)
    ham = HubbardChain(n_sites=2 * L, n_up=1, n_down=2)
    bonds = _t(ham.bonds)
    state = _state(work, ham, 96, 13)
    swap, ex, st = kawasaki.exchange_swap_acceptance_probe(work, state, bonds, 20, ham.n_unit_steps, 4)
    swap, ex = swap.numpy(), ex.numpy()
    assert swap.shape == (3,) and ex.shape == (4,)
    assert np.all(swap >= 0) and np.all(swap <= 1)
    assert np.all(ex >= 0) and np.all(ex <= 1)
    assert swap.min() > 0.05 and ex.max() > 0.05
    assert float(st.n_proposed) == 20 * ham.n_unit_steps * 96
    np.testing.assert_allclose(float(st.n_accepted), float((ex * 20 * ham.n_unit_steps * 24).sum()), rtol=1e-12)
    nb, diags = kawasaki.tune_n_beta_exchange(work, st, bonds, ham.n_unit_steps, candidates=(2, 4),
                                             warm_sweeps=10, probe_sweeps=10)
    assert nb in (2, 4) and 96 % nb == 0
    assert all(len(d["swap"]) == cand - 1 and len(d["flip"]) == cand for cand, d in diags.items())
    nb, diags = kawasaki.tune_n_beta_exchange(work, st, bonds, ham.n_unit_steps, candidates=(5, 16, 2), target=2.0,
                                             warm_sweeps=2, probe_sweeps=2)
    assert nb == 2 and list(diags) == [16, 2]  # none qualifies: the largest valid last one
    with pytest.raises(ValueError, match="divides"):
        kawasaki.tune_n_beta_exchange(work, st, bonds, ham.n_unit_steps, candidates=(5, 7), warm_sweeps=1,
                                      probe_sweeps=1)


def test_vmc_tempered_exchange_converges_to_sector_ground_state():
    """End to end at the JAX package's sizes (its :140): VMCConfig(n_beta=2)
    with the exchange sampler, RBM H=16 in float64, 512 walkers, 200 warm-up
    sweeps and 600 steps, reaches the (1,1) sector ground state of the L=3
    chain to 2e-2."""
    n = 2 * L
    ham = HubbardChain(n_sites=n, u=4.0, t=1.0, n_up=1, n_down=1, pbc=True)
    cfg = VMCConfig(n_walkers=512, learning_rate=2e-2, solver="cg", n_beta=2, seed=5)
    vmc = VMC(RBM(n_inputs=n, n_hiddens=16, dtype=torch.float64), ham, cfg, device="cpu")
    params, state = vmc.init()
    state = vmc.warm_up(params, state, 200)
    params, state, history, _ = vmc.run(params, state, 600)
    h_sec, _ = sector_restrict(hubbard_chain_dense(L, u=4.0, t=1.0, pbc=True), L, 1, 1)
    e_exact = ground_energy(h_sec)
    e = float(np.mean([x["energy"] for x in history[-30:]]))
    rel = abs(e - e_exact) / abs(e_exact)
    assert rel < 2e-2, (e, e_exact, rel)
    s = state.cache.spins
    assert ((s[:, :L] > 0).sum(1) == 1).all() and ((s[:, L:] > 0).sum(1) == 1).all()
