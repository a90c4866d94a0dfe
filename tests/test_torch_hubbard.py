"""PyTorch port vs the JAX package: the Jordan-Wigner Hubbard chain and the
Kawasaki pair-exchange sampler.

Inputs are made with numpy from a seed and handed to both packages. In
float64 the two evaluate the same formulas: the 2-flip engine agrees to
1e-12, the plain exchange rounds make the same decisions as the JAX
package's ``_exchange_scan`` on the same uniforms, and the local energy
agrees to 1e-10. The exchange sampler is also held to the exact
particle-sector |psi|^2 and the whole training loop to the sector's exact
ground state. The exchange kernel's tests are in test_torch_gpu.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_network_quantum_state_tpu.hamiltonians import HubbardChain as JHubbardChain
from neural_network_quantum_state_tpu.models import RBM as JRBM
from neural_network_quantum_state_tpu.ops import cplx as jcplx
from neural_network_quantum_state_tpu.ops import engine as jengine
from neural_network_quantum_state_tpu.ops.cplx import C
from neural_network_quantum_state_tpu.optim import sr as jsr
from neural_network_quantum_state_tpu.sampler import kawasaki as jkawasaki
from neural_network_quantum_state_tpu.utils.exact import ground_energy, hubbard_chain_dense, sector_restrict
from neural_network_quantum_state_tpu_torch import VMC, VMCConfig
from neural_network_quantum_state_tpu_torch.hamiltonians import HubbardChain, LITFIChain
from neural_network_quantum_state_tpu_torch.hamiltonians import hubbard as hubbard_mod
from neural_network_quantum_state_tpu_torch.models import RBM, params_from_jax
from neural_network_quantum_state_tpu_torch.ops import engine
from neural_network_quantum_state_tpu_torch.ops import exchange as exchange_ops
from neural_network_quantum_state_tpu_torch.ops import sweep as sweep_ops
from neural_network_quantum_state_tpu_torch.ops.rng import make_generator
from neural_network_quantum_state_tpu_torch.sampler import init_state, kawasaki

TOL = 1e-12
_DT = {"float64": (jnp.float64, torch.float64), "float32": (jnp.float32, torch.float32)}


def _np(c):
    if isinstance(c, C):
        return np.asarray(c.re) + 1j * np.asarray(c.im)
    return np.asarray(c)


def _c(x):
    return C(jnp.asarray(np.real(x)), jnp.asarray(np.imag(x)))


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _sector_spins(rng, k, l, n_up, n_down):
    """(K, 2L) float64 states with n_up particles (+1) in [0, L) and
    n_down in [L, 2L), placed at random."""
    out = -np.ones((k, 2 * l))
    for w in range(k):
        out[w, rng.permutation(l)[:n_up]] = 1.0
        out[w, l + rng.permutation(l)[:n_down]] = 1.0
    return out


def _rbm_pair(n, h, rng, scale, dtype="float64"):
    """(JAX RBM, port RBM, JAX params, port params) from one numpy draw."""
    dj, dt = _DT[dtype]
    jm, tm = JRBM(n_inputs=n, n_hiddens=h, dtype=dj), RBM(n_inputs=n, n_hiddens=h, dtype=dt)
    p_np = {name: scale * (rng.normal(size=s) + 1j * rng.normal(size=s)) for name, s in jm.param_spec()}
    if dtype == "float32":
        p_np = {name: v.astype(np.complex64) for name, v in p_np.items()}
    jp = {name: C(jnp.asarray(v.real), jnp.asarray(v.imag)) for name, v in p_np.items()}
    return jm, tm, jp, params_from_jax(tm, p_np, device="cpu")


def test_flip2_functions_match_jax(rng):
    l, h, k = 8, 12, 48
    jm, tm, jp, tp = _rbm_pair(2 * l, h, rng, 0.3)
    spins = _sector_spins(rng, k, l, 3, 4)
    jwork, work = jm.make_work(jp), tm.make_work(tp)
    jcache, _ = jengine.full_forward(jwork, jnp.asarray(spins))
    cache, _ = engine.full_forward(work, _t(spins))
    i, j = rng.integers(0, 2 * l, size=k), rng.integers(0, 2 * l, size=k)
    np.testing.assert_allclose(
        engine.flip2_log_psi_per_walker(work, cache, _t(i), _t(j)).numpy(),
        _np(jengine.flip2_log_psi_per_walker(jwork, jcache, jnp.asarray(i), jnp.asarray(j))),
        rtol=TOL, atol=TOL,
    )
    j = (i + 1 + rng.integers(0, 2 * l - 1, size=k)) % (2 * l)  # i != j, as in a pair exchange
    accept = rng.random(k) < 0.5
    jc2 = jengine.commit_flip2_per_walker(jwork, jcache, jnp.asarray(i), jnp.asarray(j), jnp.asarray(accept))
    c2 = engine.commit_flip2_per_walker(work, cache, _t(i), _t(j), _t(accept))
    np.testing.assert_array_equal(c2.spins.numpy(), np.asarray(jc2.spins))
    np.testing.assert_allclose(c2.y.numpy(), _np(jc2.y), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(c2.sa.numpy(), _np(jc2.sa), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(cache.spins.numpy(), spins)  # input left unchanged
    a_idx, b_idx = JHubbardChain(n_sites=2 * l)._hop_pairs
    np.testing.assert_allclose(
        engine.all_flip2_log_psi(work, cache, _t(a_idx).long(), _t(b_idx).long()).numpy(),
        _np(jengine.all_flip2_log_psi(jwork, jcache, jnp.asarray(a_idx), jnp.asarray(b_idx))),
        rtol=TOL, atol=TOL,
    )


@pytest.mark.parametrize("n", [2, 3, 6, 16, 64])
def test_bond_tables_match_jax(n):
    np.testing.assert_array_equal(kawasaki.ring_bonds(n), jkawasaki.ring_bonds(n))
    np.testing.assert_array_equal(kawasaki.two_ring_bonds(n), jkawasaki.two_ring_bonds(n))
    assert kawasaki.ring_bonds(n).dtype == kawasaki.two_ring_bonds(n).dtype == np.int32


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_select_active_bond_matches_jax(dtype, rng):
    """Exact agreement, including walkers with no active bond, one active
    bond, and uniforms at 0 and just below 1."""
    k, b = 512, 64
    dj, dt = _DT[dtype]
    active = rng.random((k, b)) < rng.random((k, 1))
    active[:8] = False
    active[8:16] = False
    active[8:16, rng.integers(0, b, size=8)] = True
    u = rng.random(k).astype(np.dtype(dj))
    u[::7] = 0.0
    u[1::7] = np.nextafter(np.array(1.0, np.dtype(dj)), 0)
    jbond, jnb = jkawasaki._select_active_bond(jnp.asarray(active), jnp.asarray(u))
    bond, nb = exchange_ops.select_active_bond(_t(active), _t(u))
    np.testing.assert_array_equal(bond.numpy(), np.asarray(jbond))
    np.testing.assert_array_equal(nb.numpy(), np.asarray(jnb))
    chosen = active[np.arange(k), bond.numpy()]
    assert chosen[nb.numpy() > 0].all() and set(bond.numpy()[:8]) == {b - 1}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("per_flavor_rings", [True, False], ids=["two-rings", "one-ring"])
def test_exchange_plain_matches_jax(per_flavor_rings, dtype, rng):
    """The plain exchange rounds against the JAX package's _exchange_scan on
    the same uniforms: in float64 the same decisions, acceptance count, y,
    sa and ln psi; in float32 the same decisions on >= 99.9 % of walkers
    (near-ties u ~ exp(2 dln) may go either way)."""
    l, h, n_steps = 8, 16, 48
    k = 256 if dtype == "float64" else 2048
    jm, tm, jp, tp = _rbm_pair(2 * l, h, rng, 0.3, dtype)
    ham = HubbardChain(n_sites=2 * l, n_up=3, n_down=4, per_flavor_rings=per_flavor_rings)
    dj, dt = _DT[dtype]
    spins = _sector_spins(rng, k, l, 3, 4).astype(np.dtype(dj))
    u_sel, u_acc = (rng.random((n_steps, k)).astype(np.dtype(dj)) for _ in range(2))

    jwork, work = jm.make_work(jp), tm.make_work(tp)
    jcache, jln = jengine.full_forward(jwork, jnp.asarray(spins))
    jc2, jl2, jacc = jkawasaki._exchange_scan(jwork, jcache, jln, jnp.asarray(ham.bonds), jnp.asarray(u_sel), jnp.asarray(u_acc))
    cache, ln = engine.full_forward(work, _t(spins))
    c2, l2, acc = exchange_ops.exchange_plain(work, cache, ln, _t(ham.bonds), _t(u_sel), _t(u_acc))

    same = (c2.spins.numpy() == np.asarray(jc2.spins)).all(axis=1)
    if dtype == "float64":
        assert same.all()
        assert float(acc) == float(jacc) > 0
        np.testing.assert_allclose(c2.y.numpy(), _np(jc2.y), rtol=0, atol=1e-10)
        np.testing.assert_allclose(c2.sa.numpy(), _np(jc2.sa), rtol=0, atol=1e-10)
        np.testing.assert_allclose(l2.numpy(), _np(jl2), rtol=0, atol=1e-10)
    else:
        assert same.mean() >= 0.999, same.mean()
        assert abs(float(acc) - float(jacc)) <= (~same).sum() * n_steps
    s = c2.spins.numpy()
    if per_flavor_rings:
        assert ((s[:, :l] > 0).sum(1) == 3).all() and ((s[:, l:] > 0).sum(1) == 4).all()
    else:
        assert ((s > 0).sum(1) == 7).all()


_ENERGY_CASES = {
    "pbc-trap": dict(pbc=True, trap=True),
    "obc-trap": dict(pbc=False, trap=True),
    "pbc": dict(pbc=True, trap=False),
    "one-ring-n-particles": dict(pbc=True, trap=True, per_flavor_rings=False, n_particles=6),
    "two-rings-n-particles": dict(pbc=True, trap=False, n_particles=5),
    "pbc-trap-chunked": dict(pbc=True, trap=True, chunk_elems=5 * 64 * 12),
}


@pytest.mark.parametrize("case", list(_ENERGY_CASES), ids=list(_ENERGY_CASES))
def test_local_energy_matches_jax(case, rng, monkeypatch):
    """HubbardChain.local_energy against the JAX package's at L=8, H=12, on
    states drawn by the port's init_spins (per flavor, or n_particles over
    all 2L inputs); the chunked case splits the 30 pairs into chunks of 5."""
    opts = dict(_ENERGY_CASES[case])
    if "chunk_elems" in opts:
        monkeypatch.setattr(hubbard_mod, "OFFDIAG_CHUNK_ELEMS", opts.pop("chunk_elems"))
    l, h, k = 8, 12, 64
    trap = opts.pop("trap")
    v = tuple(np.tile(0.05 * (np.arange(l) - (l - 1) / 2.0) ** 2, 2)) if trap else None
    kw = dict(n_sites=2 * l, u=4.0, t=1.0, n_up=3, n_down=2, v=v, **opts)
    jh, th = JHubbardChain(**kw), HubbardChain(**kw)
    jm, tm, jp, tp = _rbm_pair(2 * l, h, rng, 0.3)
    spins = th.init_spins(make_generator(int(rng.integers(1 << 30)), "cpu"), k, torch.float64)
    if th.n_particles is None:
        assert ((spins[:, :l] > 0).sum(1) == 3).all() and ((spins[:, l:] > 0).sum(1) == 2).all()
    else:
        assert ((spins > 0).sum(1) == th.n_particles).all()
    np.testing.assert_array_equal(th.bonds, np.asarray(jh.bonds))

    jcache, jln = jengine.full_forward(jm.make_work(jp), jnp.asarray(spins.numpy()))
    want = _np(jh.local_energy(jm.make_work(jp), jcache, jln))
    cache, ln = engine.full_forward(tm.make_work(tp), spins)
    got = th.local_energy(tm.make_work(tp), cache, ln)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("pbc", [True, False], ids=["pbc", "obc"])
def test_local_energy_matches_dense_h(pbc, rng):
    """Etilde(s) = sum_s' H[s,s'] psi(s')/psi(s) over all 2^6 states at L=3,
    with a site potential: every term, the JW edge string included, against
    the JAX package's dense JW Hamiltonian."""
    l = 3
    _, tm, _, tp = _rbm_pair(2 * l, 8, rng, 0.3)
    v = tuple(0.1 * i for i in range(2 * l))
    ham = HubbardChain(n_sites=2 * l, u=4.0, t=1.0, n_up=1, n_down=1, pbc=pbc, v=v)
    idx = np.arange(2 ** (2 * l))
    all_spins = 1.0 - 2.0 * ((idx[:, None] >> np.arange(2 * l)[None, :]) & 1)
    work = tm.make_work(tp)
    cache, ln = engine.full_forward(work, _t(all_spins))
    got = ham.local_energy(work, cache, ln).numpy()
    psi = np.exp(ln.numpy())
    want = (hubbard_chain_dense(l, u=4.0, t=1.0, pbc=pbc, v=np.asarray(v)) @ psi) / psi
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)


def test_local_energy_builds_its_tables_once_per_device_and_dtype(rng, monkeypatch):
    """The pair indices and the trap go to the walkers' device at the first
    local energy and are reused by every later one: repeated calls build
    the pair table once and give the same energies."""
    l = 4
    built = []
    pairs = HubbardChain._pairs
    monkeypatch.setattr(HubbardChain, "_pairs", lambda self: built.append(1) or pairs(self))
    v = tuple(0.1 * i for i in range(2 * l))
    ham = HubbardChain(n_sites=2 * l, u=4.0, t=1.0, n_up=2, n_down=1, v=v)
    _, tm, _, tp = _rbm_pair(2 * l, 8, rng, 0.3)
    work = tm.make_work(tp)
    cache, ln = engine.full_forward(work, ham.init_spins(make_generator(3, "cpu"), 16, torch.float64))
    first = ham.local_energy(work, cache, ln)
    for _ in range(2):
        torch.testing.assert_close(ham.local_energy(work, cache, ln), first, rtol=0, atol=0)
    assert len(built) == 2  # a and b, once each
    tables = ham.__dict__["_device_tables"]
    assert sorted(name for name, _, _ in tables) == ["pair_a", "pair_b", "v"]
    assert tables[("v", torch.device("cpu"), torch.float64)].tolist() == list(v)


def test_exchange_sweeps_sample_sector_psi2(rng):
    """kawasaki.exchange_sweeps stays in the (1, 1) sector of L=3 and samples
    |psi|^2 restricted to it: chi^2 and total variation against exact
    enumeration of its 9 states; ln psi stays consistent with the spins."""
    l, k = 3, 1024
    n = 2 * l
    _, tm, _, tp = _rbm_pair(n, 8, rng, 0.25, "float32")
    work = tm.make_work(tp)
    ham = HubbardChain(n_sites=n, n_up=1, n_down=1)
    bonds = torch.as_tensor(ham.bonds)

    idx = np.arange(2**n)
    bits = (idx[:, None] >> np.arange(n)[None, :]) & 1
    occ = 1 - bits  # s = 1 - 2 bit: occupied (+1) <-> bit 0
    in_sector = (occ[:, :l].sum(1) == 1) & (occ[:, l:].sum(1) == 1)
    work64 = RBM(n_inputs=n, n_hiddens=8, dtype=torch.float64).make_work({k_: v.to(torch.complex128) for k_, v in tp.items()})
    p = np.exp(2.0 * engine.log_psi(work64, _t(1.0 - 2.0 * bits[in_sector])).real.numpy())
    p /= p.sum()
    pos = {int(sid): i for i, sid in enumerate(idx[in_sector])}

    g = make_generator(5, "cpu")
    state = init_state(work, ham.init_spins(g, k), g)
    state = kawasaki.exchange_sweeps(work, state, bonds, 30, ham.n_unit_steps)
    counts = np.zeros(len(pos))
    bit_w = np.asarray([1 << b for b in range(n)])
    for _ in range(40):
        state = kawasaki.exchange_sweeps(work, state, bonds, 2, ham.n_unit_steps)
        for sid in ((1.0 - state.cache.spins.numpy()) / 2.0 @ bit_w).astype(int):
            counts[pos[sid]] += 1  # KeyError = left the sector
    total = counts.sum()
    chi2 = float(np.sum((counts - total * p) ** 2 / (total * p)))
    tv = 0.5 * float(np.abs(counts / total - p).sum())
    assert chi2 / (len(pos) - 1) < 3.0, (chi2, tv)
    assert tv < 0.03, tv
    assert p.max() > 2 * p.min()  # the target is far from uniform
    assert float(state.n_proposed) == 110 * n * k
    assert 0 < float(state.n_accepted) < float(state.n_proposed)
    _, ln_ref = engine.full_forward(work, state.cache.spins)
    torch.testing.assert_close(state.lnpsi, ln_ref, rtol=0, atol=2e-4)


def test_exchange_sweeps_draw_two_blocks_per_sweep():
    """n sweeps in one call are n exchange_plain calls, each on its own
    (n_unit_steps, K) selection block and acceptance block, drawn in turn
    from the state's generator."""
    l, k, n_sweeps = 4, 32, 3
    tm = RBM(n_inputs=2 * l, n_hiddens=8, dtype=torch.float64)
    work = tm.make_work({name: 20.0 * v for name, v in tm.init_params(make_generator(0, "cpu")).items()})
    ham = HubbardChain(n_sites=2 * l, n_up=2, n_down=1)
    bonds = torch.as_tensor(ham.bonds)
    state = init_state(work, ham.init_spins(make_generator(1, "cpu"), k, torch.float64), make_generator(2, "cpu"))
    calls = exchange_ops.exchange_plain.calls
    got = kawasaki.exchange_sweeps(work, state, bonds, n_sweeps, ham.n_unit_steps)
    assert exchange_ops.exchange_plain.calls == calls + n_sweeps

    g = make_generator(2, "cpu")
    cache, ln, n_acc = state.cache, state.lnpsi, 0.0
    for _ in range(n_sweeps):
        u_sel = torch.rand((2 * l, k), generator=g, dtype=torch.float64)
        u_acc = torch.rand((2 * l, k), generator=g, dtype=torch.float64)
        cache, ln, acc = exchange_ops.exchange_plain(work, cache, ln, bonds, u_sel, u_acc)
        n_acc += float(acc)
    assert torch.equal(got.cache.spins, cache.spins) and torch.equal(got.lnpsi, ln)
    assert float(got.n_accepted) == n_acc and 0 < n_acc < n_sweeps * 2 * l * k
    assert float(got.n_proposed) == n_sweeps * 2 * l * k


def test_sr_update_matches_jax_on_hubbard(rng):
    """local energy + O_k + CG solve + trust region + update on a Hubbard
    batch (L=8 with a trap, RBM H=12), against the JAX package's functions
    composed as its VMC step composes them."""
    l, h, k, lr, step = 8, 12, 256, 2e-2, 0
    kw = dict(n_sites=2 * l, u=4.0, t=1.0, n_up=3, n_down=3, v=tuple(np.tile(0.05 * (np.arange(l) - 3.5) ** 2, 2)))
    jh, th = JHubbardChain(**kw), HubbardChain(**kw)
    jm, tm, jp, tp = _rbm_pair(2 * l, h, rng, 0.3)
    spins = _sector_spins(rng, k, l, 3, 3)

    jcache, jln = jengine.full_forward(jm.make_work(jp), jnp.asarray(spins))
    htilda = jh.local_energy(jm.make_work(jp), jcache, jln)
    lam = jsr.lambda_schedule(step, dtype=jnp.float64)
    dx, jres = jsr.sr_cg_solve(jm.grad_log(jp, jcache), htilda, lam, tol=1e-5, max_iters=min(1000, jm.n_vars))
    dx = dx * min(1.0, 1.0 / max(float(jnp.sqrt(jcplx.norm2(dx))), 1e-30))
    jnew = jm.update_params(jp, dx, lr)

    vmc = VMC(tm, th, VMCConfig(n_walkers=k, learning_rate=lr), device="cpu")
    cache, ln = engine.full_forward(tm.make_work(tp), _t(spins))
    new, stats = vmc.sr_update(tp, cache, ln, step)
    assert stats.cg_iters == int(jres.iterations)
    np.testing.assert_allclose(stats.energy.numpy(), _np(jsr.energy_and_rsd(htilda)[0]), rtol=1e-12)
    for name in tp:
        np.testing.assert_allclose(new[name].numpy(), _np(jnew[name]), rtol=1e-8, atol=1e-8)


def test_vmc_chooses_the_exchange_sampler(monkeypatch):
    """An exchange Hamiltonian's warm-up and steps go through the exchange
    rounds, one call per sweep, never through the single-flip sweep; the
    sector holds; block moves are refused and a collapse with the exchange
    kernel reseeds in the sector instead of escalating."""
    l, k = 4, 64
    ham = HubbardChain(n_sites=2 * l, n_up=2, n_down=1)
    machine = RBM(n_inputs=2 * l, n_hiddens=8, dtype=torch.float32)
    vmc = VMC(machine, ham, VMCConfig(n_walkers=k, use_fused_sweeps=True, seed=1), device="cpu")
    assert vmc.bonds.dtype == torch.int32 and vmc.bonds.shape == (2 * l, 2)
    ex0, sw0 = exchange_ops.exchange_plain.calls, sweep_ops.sweep_plain.calls
    params, state = vmc.init()
    state = vmc.warm_up(params, state, 5)
    params, state, history, _ = vmc.run(params, state, 3)
    assert exchange_ops.exchange_plain.calls == ex0 + 5 + 3
    assert sweep_ops.sweep_plain.calls == sw0
    assert float(state.n_proposed) == (5 + 3) * 2 * l * k
    s = state.cache.spins
    assert ((s[:, :l] > 0).sum(1) == 2).all() and ((s[:, l:] > 0).sum(1) == 1).all()
    assert all(np.isfinite(r["energy"]) for r in history)

    assert not vmc._can_escalate()
    assert VMC(machine, ham, VMCConfig(n_walkers=k), device="cpu")._can_escalate()
    assert VMC(machine, LITFIChain(n_sites=2 * l), VMCConfig(n_walkers=k, use_fused_sweeps=True), device="cpu")._can_escalate()
    with pytest.raises(ValueError, match="particle conservation"):
        VMC(machine, ham, VMCConfig(block_moves_per_sweep=1), device="cpu")
    with pytest.raises(ValueError, match="use_fused_sweeps"):
        VMC(machine, ham, VMCConfig(n_walkers=k, n_beta=2, use_fused_sweeps=True), device="cpu")
    tempered = VMC(machine, ham, VMCConfig(n_walkers=k, n_beta=2), device="cpu")  # tempered exchange
    assert not tempered._can_escalate()

    # a collapsed ensemble is reseeded with sector states
    monkeypatch.setattr("neural_network_quantum_state_tpu_torch.vmc._COLLAPSE_RSD", float("inf"))
    cfg = dataclasses.replace(vmc.config, collapse_patience=1, collapse_requil_sweeps=2)
    vmc2 = VMC(machine, ham, cfg, device="cpu")
    params, state = vmc2.init()
    params, state, _, _ = vmc2.run(params, state, 2)
    assert vmc2.n_remediations == 1
    s = state.cache.spins
    assert ((s[:, :l] > 0).sum(1) == 2).all() and ((s[:, l:] > 0).sum(1) == 1).all()


def test_hubbard_vmc_converges_to_sector_ground_state():
    """The JAX package's Hubbard e2e oracle (tests/test_hubbard.py): L=3,
    one up and one down particle, RBM H=16, float64; the energy of the last
    30 steps within 2e-2 of the sector's exact ground state."""
    l = 3
    n = 2 * l
    ham = HubbardChain(n_sites=n, u=4.0, t=1.0, n_up=1, n_down=1, pbc=True)
    cfg = VMCConfig(n_walkers=256, learning_rate=2e-2, solver="cg", seed=5)
    vmc = VMC(RBM(n_inputs=n, n_hiddens=16, dtype=torch.float64), ham, cfg, device="cpu")
    params, state = vmc.init()
    state = vmc.warm_up(params, state, 200)
    params, state, history, _ = vmc.run(params, state, 600)
    h_sec, _ = sector_restrict(hubbard_chain_dense(l, u=4.0, t=1.0, pbc=True), l, 1, 1)
    e_exact = ground_energy(h_sec)
    e = float(np.mean([x["energy"] for x in history[-30:]]))
    assert abs(e - e_exact) / abs(e_exact) < 2e-2, (e, e_exact)
