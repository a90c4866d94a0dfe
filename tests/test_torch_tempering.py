"""PyTorch port vs the JAX package: parallel tempering (n_beta > 1).

The plain tempered sweep is held to the JAX package's
``tempering._tempered_flip_scan`` + ``_swap_phase`` decision for decision
on the same numpy uniforms (float64); the beta = 1 replicas are held to
exact |psi|^2; the ladder probe and ``tune_n_beta`` to the behaviour the
JAX package's tests pin; tempered VMC to exact diagonalization; and the
collapse escalation of ``VMC.run`` to the JAX driver test's scenario. The
CUDA kernel's tempered tests are in test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_network_quantum_state_tpu.models import RBM as JRBM
from neural_network_quantum_state_tpu.models import RBMTrSymm as JRBMTrSymm
from neural_network_quantum_state_tpu.ops import engine as jengine
from neural_network_quantum_state_tpu.ops.cplx import C
from neural_network_quantum_state_tpu.sampler import tempering as jtempering
from neural_network_quantum_state_tpu.utils.exact import ground_energy, spins_to_index, tfi_chain_dense
from neural_network_quantum_state_tpu_torch import VMC, VMCConfig
from neural_network_quantum_state_tpu_torch.hamiltonians import LITFIChain, TFIChain
from neural_network_quantum_state_tpu_torch.models import RBM, RBMTrSymm, params_from_jax
from neural_network_quantum_state_tpu_torch.ops import engine
from neural_network_quantum_state_tpu_torch.ops import sweep as sweep_ops
from neural_network_quantum_state_tpu_torch.ops.rng import make_generator
from neural_network_quantum_state_tpu_torch.sampler import chain_checkerboard, init_state, tempering


def _np(c):
    return np.asarray(c.re) + 1j * np.asarray(c.im)


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("n_beta", [2, 3, 4])
@pytest.mark.parametrize("kind", ["RBM", "RBMTrSymm"])
def test_plain_tempered_sweep_matches_jax_decision_for_decision(kind, n_beta, rng):
    """Three sweeps of tempered flips + even + odd swap phases on shared
    uniforms: the same spins, y/sa/ln psi within 1e-12, the same flip
    acceptance per row and the same accepted lower swaps per row."""
    n, kb, n_sweeps = 8, 24, 3
    k = kb * n_beta
    if kind == "RBM":
        jm, tm = JRBM(n_inputs=n, n_hiddens=10, dtype=jnp.float64), RBM(n_inputs=n, n_hiddens=10, dtype=torch.float64)
    else:
        jm, tm = JRBMTrSymm(n_inputs=n, alpha=2, dtype=jnp.float64), RBMTrSymm(n_inputs=n, alpha=2, dtype=torch.float64)
    p_np = {name: 0.4 * (rng.normal(size=s) + 1j * rng.normal(size=s)) for name, s in jm.param_spec()}
    jp = {name: C(jnp.asarray(v.real), jnp.asarray(v.imag)) for name, v in p_np.items()}
    spins = np.where(rng.random((k, n)) < 0.5, -1.0, 1.0)
    sched = chain_checkerboard(n)
    u_flip = rng.random((n_sweeps * n, k))
    u_swap = rng.random((n_sweeps, 2, k))

    jwork = jm.make_work(jp)
    jcache, jln = jengine.full_forward(jwork, jnp.asarray(spins))
    beta = jtempering.replica_betas(n_beta, kb, jnp.float64)
    jflip, jswap = np.zeros(k), np.zeros(k)
    for s in range(n_sweeps):
        jcache, jln, n_acc = jtempering._tempered_flip_scan(
            jwork, jcache, jln, jnp.asarray(sched), jnp.asarray(u_flip[s * n:(s + 1) * n]), beta
        )
        jflip += np.asarray(n_acc)
        for parity in (0, 1):
            jcache, jln, acc_lower = jtempering._swap_phase(jcache, jln, jnp.asarray(u_swap[s, parity]), parity, n_beta, kb)
            jswap += np.asarray(acc_lower)

    work = tm.make_work(params_from_jax(tm, p_np, device="cpu"))
    cache, ln = engine.full_forward(work, _t(spins))
    c2, l2, rows = sweep_ops.sweep_plain(work, cache, ln, _t(sched), _t(u_flip), n_beta, _t(u_swap), rows=True)

    np.testing.assert_array_equal(c2.spins.numpy(), np.asarray(jcache.spins))
    np.testing.assert_allclose(c2.y.numpy(), _np(jcache.y), rtol=0, atol=1e-12)
    np.testing.assert_allclose(c2.sa.numpy(), _np(jcache.sa), rtol=0, atol=1e-12)
    np.testing.assert_allclose(l2.numpy(), _np(jln), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(rows[0].numpy(), jflip)
    np.testing.assert_array_equal(rows[1].numpy(), jswap)
    assert 0 < jswap.sum() < n_sweeps * kb * (n_beta - 1)  # some swaps taken, some refused
    # the sum the plain sweep returns without rows is the flip count
    _, _, total = sweep_ops.sweep_plain(work, cache, ln, _t(sched), _t(u_flip), n_beta, _t(u_swap))
    assert float(total) == jflip.sum()
    # the tempering module's rounds and swap phase, composed as JAX composes them
    c3, l3 = cache, ln
    beta_t = tempering.replica_betas(n_beta, kb, torch.float64)
    for s in range(n_sweeps):
        c3, l3, _ = tempering._tempered_flip_rounds(work, c3, l3, sched.tolist(), _t(u_flip[s * n:(s + 1) * n]), beta_t)
        for parity in (0, 1):
            c3, l3, _ = tempering._swap_phase(c3, l3, _t(u_swap[s, parity]), parity, n_beta)
    assert torch.equal(c3.spins, c2.spins) and torch.equal(c3.y, c2.y) and torch.equal(l3, l2)


def test_replica_betas_match_jax():
    for n_beta, kb in ((1, 3), (4, 5), (6, 2)):
        want = np.asarray(jtempering.replica_betas(n_beta, kb, jnp.float32))
        np.testing.assert_array_equal(sweep_ops.replica_betas(n_beta, kb).numpy(), want)


def test_tempered_sweep_refuses_a_bad_layout():
    n, k = 4, 12
    tm = RBM(n_inputs=n, n_hiddens=4, dtype=torch.float64)
    work = tm.make_work(tm.init_params(make_generator(0, "cpu")))
    cache, ln = engine.full_forward(work, torch.ones((k, n), dtype=torch.float64))
    sched = torch.as_tensor(chain_checkerboard(n))
    u = torch.rand((2 * n, k), dtype=torch.float64)
    with pytest.raises(ValueError, match="multiple of n_beta"):
        sweep_ops.sweep_plain(work, cache, ln, sched, u, 5, torch.rand((2, 2, k), dtype=torch.float64))
    with pytest.raises(ValueError, match="whole sweeps"):
        sweep_ops.sweep_plain(work, cache, ln, sched, u[:-1], 4, torch.rand((2, 2, k), dtype=torch.float64))
    with pytest.raises(ValueError, match="swap uniforms"):
        sweep_ops.sweep_plain(work, cache, ln, sched, u, 4, None)
    with pytest.raises(ValueError, match="multiple of n_beta"):
        tempering.tempering_sweeps(work, init_state(work, cache.spins, make_generator(1, "cpu")), sched, 1, 5)


def test_cache_consistent_through_swaps():
    """After 15 tempered sweeps the carried cache and ln psi are those of a
    fresh forward pass on the final spins (JAX test_tempering.py:18)."""
    n, n_beta, kb = 6, 4, 16
    tm = RBM(n_inputs=n, n_hiddens=10, dtype=torch.float64)
    work = tm.make_work({name: 20.0 * v for name, v in tm.init_params(make_generator(0, "cpu")).items()})
    state = init_state(work, torch.ones((n_beta * kb, n), dtype=torch.float64), make_generator(1, "cpu"))
    state = tempering.tempering_sweeps(work, state, torch.as_tensor(chain_checkerboard(n)), 15, n_beta)
    fresh, ln_ref = engine.full_forward(work, state.cache.spins)
    torch.testing.assert_close(state.lnpsi, ln_ref, rtol=1e-9, atol=1e-12)
    torch.testing.assert_close(state.cache.y, fresh.y, rtol=1e-9, atol=1e-12)
    torch.testing.assert_close(state.cache.sa, fresh.sa, rtol=1e-9, atol=1e-12)
    assert float(state.n_proposed) == 15 * n * n_beta * kb
    assert 0 < float(state.n_accepted) < float(state.n_proposed)
    assert not torch.equal(state.cache.spins, torch.ones_like(state.cache.spins))


def test_beta1_slice_reproduces_psi_squared(rng):
    """The beta = 1 replicas ([::n_beta]) sample |psi|^2 at N=4: every
    state's frequency within 5 sigma + 4e-3 of exact (JAX
    test_tempering.py:31), and chi^2 per degree of freedom under 3."""
    n, n_beta, kb = 4, 4, 1024
    jm = JRBM(n_inputs=n, n_hiddens=8, dtype=jnp.float64)
    tm = RBM(n_inputs=n, n_hiddens=8, dtype=torch.float64)
    p_np = {name: 0.5 * (rng.normal(size=s) + 1j * rng.normal(size=s)) for name, s in jm.param_spec()}
    work = tm.make_work(params_from_jax(tm, p_np, device="cpu"))

    idx = np.arange(2**n)
    all_spins = 1.0 - 2.0 * ((idx[:, None] >> np.arange(n)[None, :]) & 1)
    jwork = jm.make_work({name: C(jnp.asarray(v.real), jnp.asarray(v.imag)) for name, v in p_np.items()})
    p_exact = np.exp(2.0 * np.asarray(jengine.log_psi(jwork, jnp.asarray(all_spins, jnp.float64)).re))
    p_exact /= p_exact.sum()
    assert p_exact.max() > 4 * p_exact.min()  # far from uniform

    g = make_generator(11, "cpu")
    state = init_state(work, torch.where(torch.rand((n_beta * kb, n), generator=g) < 0.5, -1.0, 1.0).double(), g)
    sched = torch.as_tensor(chain_checkerboard(n))
    state = tempering.tempering_sweeps(work, state, sched, 100, n_beta)
    counts = np.zeros(2**n)
    n_samples = 0
    for _ in range(4):
        state = tempering.tempering_sweeps(work, state, sched, 20, n_beta)
        counts += np.bincount(spins_to_index(state.cache.spins.numpy()[::n_beta]), minlength=2**n)
        n_samples += kb
    p_emp = counts / n_samples
    tol = 5.0 * np.sqrt(p_exact / n_samples) + 4e-3
    assert np.all(np.abs(p_emp - p_exact) < tol), (p_emp, p_exact)
    chi2 = float(np.sum((counts - n_samples * p_exact) ** 2 / (n_samples * p_exact)))
    assert chi2 / (2**n - 1) < 3.0, chi2


def _pinned(n=8, scale=3.0, k=96):
    """An RBM with a strong Neel-aligned visible bias, all walkers on the
    Neel state: the beta = 1 chain nearly freezes (flip accept ~
    e^{-4 scale}) while hot replicas mix (JAX test_autonbeta.py:26)."""
    tm = RBM(n_inputs=n, n_hiddens=4, dtype=torch.float64)
    params = dict(tm.init_params(make_generator(0, "cpu")))
    neel = torch.where(torch.arange(n) % 2 == 0, 1.0, -1.0).double()
    params["a"] = (scale * neel).to(torch.complex128)
    work = tm.make_work(params)
    state = init_state(work, neel.expand(k, n).contiguous(), make_generator(1, "cpu"))
    return work, state, torch.as_tensor(chain_checkerboard(n))


def test_swap_acceptance_probe_shapes_and_hot_replica_mixing():
    """JAX test_autonbeta.py:41: rates in [0, 1] of shapes (n_beta-1,) and
    (n_beta,), the probe advances the chain, colder replicas flip less, and
    the hottest replica of an 8-rung ladder mixes more than of a 2-rung one."""
    flips = {}
    for nb in (2, 8):
        work, state, sched = _pinned(k=nb * 64)
        state = tempering.tempering_sweeps(work, state, sched, 40, nb)
        swap, flip, state2 = tempering.swap_acceptance_probe(work, state, sched, 30, nb)
        assert swap.shape == (nb - 1,) and flip.shape == (nb,)
        assert bool(((swap >= 0) & (swap <= 1)).all()) and bool(((flip >= 0) & (flip <= 1)).all())
        assert float(state2.n_proposed) > float(state.n_proposed)
        assert float(state2.n_accepted) - float(state.n_accepted) == pytest.approx(float(flip.sum()) * 30 * 8 * 64)
        assert flip[0] < flip[-1]
        flips[nb] = flip
    assert flips[8][-1] > flips[2][-1]


def test_tune_n_beta_needs_a_mixing_hot_replica():
    """JAX test_autonbeta.py:63: on a pinned ensemble small ladders swap
    trivially; the mixing criterion rejects n_beta = 2."""
    work, state, sched = _pinned(scale=3.0, k=96)
    nb, diags = tempering.tune_n_beta(work, state, sched, candidates=(2, 4, 6, 8), target=0.2,
                                      mix_target=0.1, warm_sweeps=20, probe_sweeps=20)
    assert nb in (2, 4, 6, 8) and 96 % nb == 0
    d = diags[nb]
    assert len(d["swap"]) == nb - 1 and len(d["flip"]) == nb
    assert (min(d["swap"]) >= 0.2 and max(d["flip"]) >= 0.1) or nb == 8
    assert 2 in diags and max(diags[2]["flip"]) < 0.1
    assert nb > 2


def test_tune_n_beta_respects_divisibility():
    """JAX test_autonbeta.py:87: a candidate that does not divide the walker
    count per device is skipped; with an unreachable target the last valid
    candidate is returned; none valid raises."""
    work, state, sched = _pinned(n=6, k=96)
    nb, diags = tempering.tune_n_beta(work, state, sched, candidates=(16, 2), target=2.0,
                                      warm_sweeps=5, probe_sweeps=5, n_devices=4)
    assert nb == 2 and list(diags) == [2]
    with pytest.raises(ValueError, match="divides"):
        tempering.tune_n_beta(work, state, sched, candidates=(5, 7), warm_sweeps=1, probe_sweeps=1)


def test_pt_vmc_converges():
    """Tempered VMC (n_beta = 4) on the TFI chain, N=8, against exact
    diagonalization (JAX test_tempering.py:65, rel < 5e-3)."""
    n = 8
    vmc = VMC(
        RBM(n_inputs=n, n_hiddens=16, dtype=torch.float64),
        TFIChain(n_sites=n, h=-1.0, j=-1.0),
        VMCConfig(n_walkers=512, learning_rate=1e-2, solver="cg", n_beta=4, seed=17),
        device="cpu",
    )
    params, state = vmc.init()
    state = vmc.warm_up(params, state, 150)
    params, state, history, _ = vmc.run(params, state, 400)
    e_exact = ground_energy(tfi_chain_dense(n, h=-1.0, j=-1.0))
    e = float(np.mean([h["energy"] for h in history[-20:]]))
    rel = abs(e - e_exact) / abs(e_exact)
    assert rel < 5e-3, (e, e_exact, rel)
    assert state.cache.spins.shape == (512, n)


def test_collapse_escalates_to_tempering_and_completes(capsys):
    """JAX test_drivers.py:322: walkers pinned on the Neel state of a
    near-deterministic machine; run() detects the zero-variance signature,
    escalates to n_beta = 4, and completes every iteration with finite
    energies. The frozen run accepts no flip; the ladder's hot replicas do,
    in every step after the escalation. (The beta = 1 replicas stay pinned:
    the JAX test's nonzero rsd after the rescue is float64 roundoff of the
    variance of identical local energies, ~1e-8, which the port's sums do
    not show; rsd is not compared.)"""
    n, k = 8, 64
    vmc = VMC(
        RBM(n_inputs=n, n_hiddens=4, dtype=torch.float64),
        LITFIChain(n_sites=n, j=1.0, h=-0.01, alpha=2.5, pbc=True),
        VMCConfig(n_walkers=k, learning_rate=1e-3, solver="cg", seed=3, collapse_patience=2,
                  collapse_escalate_nbeta=4, collapse_requil_sweeps=1, rsd_cutoff=1e-9),
        device="cpu",
    )
    assert vmc._can_escalate()
    params, state = vmc.init()
    params = dict(params)
    params["a"] = (3.0 * torch.where(torch.arange(n) % 2 == 0, 1.0, -1.0).double()).to(torch.complex128)
    params, state, hist, _ = vmc.run(params, state, 30)
    out = capsys.readouterr().out
    assert "escalating to parallel tempering (n_beta=4)" in out
    assert vmc.n_remediations >= 1
    assert len(hist) == 30 and [h["step"] for h in hist] == list(range(30))
    assert all(np.isfinite(h["energy"]) for h in hist)
    assert hist[0]["acceptance"] == 0.0 and hist[1]["acceptance"] == 0.0
    assert all(h["acceptance"] > 0.0 for h in hist[2:])
