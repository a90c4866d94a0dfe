"""PyTorch port vs the JAX package: the spin measurement estimators.

Deterministic parity: every estimator's per-iteration body runs on the
same spins and parameters in both packages (a stub sampler hands each body
one fixed state, made from seeded numpy spins; the parameters cross with
``params_from_jax``), held at 1e-10 in float64 and 1e-5 in float32; the
site-chunked flip ratios unchunked and with the chunk bound lowered; the
blocked jackknife and the Binder cumulant on the same trials.

Statistics: the exact-enumeration cases of the JAX package's
tests/test_measurements.py at its bars (never bitwise: the two packages'
random streams differ), the chunked estimator loop against the unchunked
one from one seed, and the sampler's surface (the beta = 1 slice, the
errors it raises). The increment-trick Renyi estimator is in
test_torch_renyi_increment.py, the fermion estimators in
test_torch_fermion_meas.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_network_quantum_state_tpu.hamiltonians import LITFIChain as JLITFIChain
from neural_network_quantum_state_tpu.measurements import estimators as jest
from neural_network_quantum_state_tpu.models import REGISTRY as JREGISTRY
from neural_network_quantum_state_tpu.ops import engine as jengine
from neural_network_quantum_state_tpu.ops.cplx import C
from neural_network_quantum_state_tpu_torch.hamiltonians import LITFIChain
from neural_network_quantum_state_tpu_torch.measurements import (
    AmplitudeSampler,
    correlation_ratio,
    fidelity,
    overlap_integral,
    renyi2_entropy,
    spin_x_correlation,
    spin_z_correlation,
    spontaneous_magnetization,
    structure_factor_trials,
)
from neural_network_quantum_state_tpu_torch.measurements import estimators as est
from neural_network_quantum_state_tpu_torch.measurements.sampler import run_pair_estimator
from neural_network_quantum_state_tpu_torch.models import REGISTRY, RBM, params_from_jax
from neural_network_quantum_state_tpu_torch.ops import engine
from neural_network_quantum_state_tpu_torch.ops.rng import make_generator
from neural_network_quantum_state_tpu_torch.parallel import make_mesh

N = 6
TOL = {torch.float64: 1e-10, torch.float32: 1e-5}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _all_spins(n):
    idx = np.arange(2**n)
    bits = (idx[:, None] >> np.arange(n)[None, :]) & 1
    return 1.0 - 2.0 * bits  # (2^n, n)


def _machine(seed, n=N, h=10):
    """A port RBM(n, h) in float64 with its seeded init parameters."""
    m = RBM(n_inputs=n, n_hiddens=h, dtype=torch.float64)
    return m, m.init_params(make_generator(seed, "cpu"))


def _psi_vector(machine, params, n=N):
    ln = engine.log_psi(machine.make_work(params), torch.as_tensor(_all_spins(n)))
    return np.exp(ln.numpy())


def _exact_probs(machine, params, n=N):
    p = np.abs(_psi_vector(machine, params, n)) ** 2
    return p / p.sum()


# ---------------------------------------------------------------------------
# Deterministic parity of the per-iteration bodies


def _pair_machines(kind, n, width, seed, scale, dtype):
    """The same machine in both packages: the JAX package's seeded init
    parameters times `scale`, carried to the port with params_from_jax."""
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    alpha_kind = kind.endswith("symm")
    kw = {"alpha": width} if alpha_kind else {"n_hiddens": width}
    jm = JREGISTRY[kind](n_inputs=n, dtype=jdt, **kw)
    jp = {k: C(scale * v.re, scale * v.im) for k, v in jm.init_params(jax.random.PRNGKey(seed)).items()}
    tm = REGISTRY[kind](n_inputs=n, dtype=dtype, **kw)
    tp = params_from_jax(tm, {k: (np.asarray(v.re), np.asarray(v.im)) for k, v in jp.items()}, device="cpu")
    return jm, jp, tm, tp


class _Stub:
    """A sampler that hands every body one fixed state: run_estimator
    evaluates the body once, keeps its outputs and returns them as two
    identical iterations (the estimators' error bars need two)."""

    def __init__(self, pkg, machine, params, spins):
        self.pkg, self.machine, self.n_inputs = pkg, machine, machine.n_inputs
        self.work = machine.make_work(params)
        if pkg == "jax":
            self.cache, self.lnpsi = jengine.full_forward(self.work, jnp.asarray(spins, machine.real_dtype))
        else:
            self.cache, self.lnpsi = engine.full_forward(self.work, torch.as_tensor(spins, dtype=machine.dtype))
        self.device = torch.device("cpu")
        self.outputs = None

    def warm_up(self, n):
        pass

    def keep(self, out):
        self.outputs = out
        return jax.tree_util.tree_map(lambda x: np.repeat(np.asarray(x)[None], 2, axis=0), out)

    def run_estimator(self, accum, n_iterations, n_sweeps=1, chunk=None):
        return self.keep(accum(self.cache, self.lnpsi))


def _stub_pair(s1, s2, accum, n_iterations, n_sweeps=1, chunk=None):
    return s1.keep(accum(s1.cache, s1.lnpsi, s2.cache, s2.lnpsi))


def _as_list(out):
    leaves = jax.tree_util.tree_leaves(out) if not isinstance(out, torch.Tensor) else [out]
    return [np.asarray(x) for x in leaves]


def _run_body(name, pkg, machine, params, machine2, params2, spins, spins2):
    """Run estimator `name` of package `pkg` on stub samplers; returns the
    body's outputs as numpy arrays."""
    mod = jest if pkg == "jax" else est
    s1 = _Stub(pkg, machine, params, spins)
    s2 = _Stub(pkg, machine2, params2, spins2)
    n = machine.n_inputs
    if name == "energy":
        ham = (JLITFIChain if pkg == "jax" else LITFIChain)(n_sites=n, h=-0.7, j=0.6, alpha=2.5, pbc=True)
        mod.measure_energy((s1, ham), 2)
    elif name == "smag":
        mod.spontaneous_magnetization(s1, 2, return_trials=True)
    elif name == "order_complex":
        coeff = np.exp(1j * 0.7 * np.arange(n)) * (1.0 + 0.1 * np.arange(n))
        if pkg == "jax":
            coeff = C(jnp.asarray(coeff.real, machine.real_dtype), jnp.asarray(coeff.imag, machine.real_dtype))
        mod.order_parameter(s1, coeff, 2, return_trials=True)
    elif name == "neel":
        mod.neel_order(s1, int(round(n**0.5)), 2)
    elif name == "structure_factor":
        mod.structure_factor_trials(s1, [np.pi, np.pi + 2 * np.pi / n, 0.3], 2)
    elif name == "overlap":
        mod.overlap_integral(s1, machine2.make_work(params2), 2)
    elif name == "renyi":
        mod.renyi2_entropy(s1, s2, n // 2, 2)
    elif name == "fidelity":
        mod.fidelity(s1, s2, 2)
    elif name == "zz":
        mod.spin_z_correlation(s1, 2)
    elif name == "xx":
        mod.spin_x_correlation(s1, 2)
    return _as_list(s1.outputs)


F64, F32 = torch.float64, torch.float32
BODY_CASES = [
    ("energy", "rbm", 8, 6, F64), ("energy", "ffnntrsymm", 8, 2, F64), ("energy", "rbm", 8, 6, F32),
    ("smag", "rbmtrsymm", 8, 2, F64), ("order_complex", "rbm", 7, 5, F64), ("order_complex", "rbm", 7, 5, F32),
    ("neel", "rbm", 9, 5, F64), ("structure_factor", "rbm", 8, 6, F64), ("overlap", "rbm", 8, 6, F64),
    ("overlap", "ffnn", 6, 5, F64), ("overlap", "ffnn", 6, 5, F32), ("renyi", "rbmtrsymm", 8, 2, F64),
    ("renyi", "ffnntrsymm", 8, 2, F64), ("renyi", "rbmtrsymm", 8, 2, F32), ("fidelity", "rbm", 8, 6, F64),
    ("fidelity", "ffnn", 6, 5, F64), ("zz", "rbm", 7, 4, F64), ("xx", "rbm", 6, 5, F64),
    ("xx", "ffnntrsymm", 6, 2, F64), ("xx", "rbm", 6, 5, F32),
]


@pytest.mark.parametrize("name, kind, n, width, dtype", BODY_CASES,
                         ids=[f"{c[0]}-{c[1]}-{'f64' if c[4] == F64 else 'f32'}" for c in BODY_CASES])
def test_estimator_bodies_match_jax(name, kind, n, width, dtype, monkeypatch):
    """Each estimator's per-iteration outputs on the same spins and
    parameters (and, for the two-state estimators, a second machine and
    replica) in both packages."""
    jm, jp, tm, tp = _pair_machines(kind, n, width, 3, 2.0, dtype)
    _, jp2, _, tp2 = _pair_machines(kind, n, width, 4, 2.0, dtype)
    rng = np.random.default_rng(11)
    spins, spins2 = (np.where(rng.random((64, n)) < 0.5, 1.0, -1.0) for _ in range(2))
    monkeypatch.setattr(jest, "run_pair_estimator", _stub_pair)
    monkeypatch.setattr(est, "run_pair_estimator", _stub_pair)
    want = _run_body(name, "jax", jm, jp, jm, jp2, spins, spins2)
    got = _run_body(name, "torch", tm, tp, tm, tp2, spins, spins2)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL[dtype] * scale)


@pytest.mark.parametrize("elems", [None, 1, 7 * 64 * 8], ids=["unchunked", "one-site", "seven-sites"])
def test_flip_ratio_means_match_jax(elems, monkeypatch):
    """_flip_ratio_means with the default chunk bound (one block) and with
    the bound lowered as tests/test_measurements.py does (one site a block,
    and blocks that leave a remainder), against the JAX package's."""
    jm, jp, tm, tp = _pair_machines("rbm", 12, 8, 5, 2.0, torch.float64)
    spins = np.where(np.random.default_rng(3).random((64, 12)) < 0.5, 1.0, -1.0)
    if elems is not None:
        monkeypatch.setattr(jest, "_FLIP_CHUNK_ELEMS", elems)
        monkeypatch.setattr(est, "_FLIP_CHUNK_ELEMS", elems)
    jwork = jm.make_work(jp)
    jcache, jln = jengine.full_forward(jwork, jnp.asarray(spins))
    twork = tm.make_work(tp)
    tcache, tln = engine.full_forward(twork, torch.as_tensor(spins))
    want = np.asarray(jest._flip_ratio_means(jwork, jcache, jln, 12))
    got = est._flip_ratio_means(twork, tcache, tln, 12).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("size, n_blocks", [(60, 20), (37, 20), (5, 20), (2, 3)])
def test_blocked_jackknife_and_binder_match_jax(size, n_blocks):
    rng = np.random.default_rng(size)
    m2 = 0.3 + 0.05 * rng.random(size)
    m4 = m2**2 * (1.2 + 0.1 * rng.random(size))
    got = est._blocked_jackknife(lambda a, b: b / a, (m2, m4), n_blocks)
    want = jest._blocked_jackknife(lambda a, b: b / a, (m2, m4), n_blocks)
    assert got[:2] == pytest.approx(want[:2], rel=1e-12, abs=1e-15)
    for g, w in zip(got[2], want[2]):
        np.testing.assert_array_equal(g, w)
    assert est.binder_cumulant(m2, m4, n_blocks) == pytest.approx(jest.binder_cumulant(m2, m4, n_blocks), rel=1e-12)
    with pytest.raises(ValueError, match="needs >= 2"):
        est._blocked_jackknife(lambda a: a, (m2[:1],))


# ---------------------------------------------------------------------------
# Statistics: the JAX package's exact-enumeration cases


def test_overlap_integral_vs_exact():
    m1, p1 = _machine(0)
    m2, p2 = _machine(1)
    psi1, psi2 = _psi_vector(m1, p1), _psi_vector(m2, p2)
    want = np.sum(np.conj(psi1) * psi2) / np.sum(np.abs(psi1) ** 2)
    smp = AmplitudeSampler(m1, p1, n_walkers=2048, key=5, device="cpu")
    got, re_err, im_err = overlap_integral(smp, m2.make_work(p2), n_trials=40, n_warmup=150, n_sweeps=3)
    assert abs(got.real - want.real) < 5 * re_err + 0.02, (got, want)
    assert abs(got.imag - want.imag) < 5 * im_err + 0.02, (got, want)


def test_renyi2_vs_exact():
    m1, p1 = _machine(2)
    psi = _psi_vector(m1, p1)
    psi = psi / np.linalg.norm(psi)
    l = 3
    psi_mat = psi.reshape(2 ** (N - l), 2**l)
    rho_a = psi_mat.T @ psi_mat.conj()
    s2_exact = -np.log(np.real(np.trace(rho_a @ rho_a)))
    s1 = AmplitudeSampler(m1, p1, n_walkers=2048, key=7, device="cpu")
    s2 = AmplitudeSampler(m1, p1, n_walkers=2048, key=987654321, device="cpu")
    got, err = renyi2_entropy(s1, s2, l, n_iterations=50, n_sweeps=2, n_warmup=150, return_error=True)
    assert abs(got - s2_exact) < 0.08, (got, s2_exact)
    assert 0.0 < err < 0.08


def test_fidelity_vs_exact():
    m1, p1 = _machine(3)
    m2, p2 = _machine(4)
    psi1, psi2 = _psi_vector(m1, p1), _psi_vector(m2, p2)
    want = abs(np.vdot(psi1, psi2)) / (np.linalg.norm(psi1) * np.linalg.norm(psi2))
    s1 = AmplitudeSampler(m1, p1, n_walkers=2048, key=9, device="cpu")
    s2 = AmplitudeSampler(m2, p2, n_walkers=2048, key=10, device="cpu")
    got, err = fidelity(s1, s2, n_meas=40, n_warmup=150, n_sweeps=2)
    assert abs(got - want) < 10 * err + 0.03, (got, want, err)


def test_smag_and_zz_vs_exact():
    m1, p1 = _machine(5)
    p = _exact_probs(m1, p1)
    s = _all_spins(N)
    m_abs = np.abs(s.mean(axis=1))
    want_zz = (s[:, :, None] * s[:, None, :] * p[:, None, None]).sum(axis=0)
    smp = AmplitudeSampler(m1, p1, n_walkers=4096, key=12, device="cpu")
    m1_got, m2_got, m4_got = spontaneous_magnetization(smp, n_iterations=30, n_sweeps=2, n_warmup=150)
    assert abs(m1_got - float((p * m_abs).sum())) < 0.02
    assert abs(m2_got - float((p * m_abs**2).sum())) < 0.02
    assert abs(m4_got - float((p * m_abs**4).sum())) < 0.02
    smp2 = AmplitudeSampler(m1, p1, n_walkers=4096, key=13, device="cpu")
    zz = spin_z_correlation(smp2, n_iterations=30, n_sweeps=2, n_warmup=150)
    np.testing.assert_allclose(zz, want_zz, atol=0.04)


def test_spin_x_correlation_vs_exact():
    m1, p1 = _machine(6)
    psi = _psi_vector(m1, p1)
    norm2 = np.sum(np.abs(psi) ** 2)
    idx = np.arange(2**N)
    want_s = np.zeros(N)
    want_ss = np.eye(N)
    for i in range(N):
        fi = idx ^ (1 << i)
        want_s[i] = np.real(np.sum(np.conj(psi) * psi[fi])) / norm2
        for j in range(N):
            if j != i:
                want_ss[i, j] = np.real(np.sum(np.conj(psi) * psi[fi ^ (1 << j)])) / norm2
    smp = AmplitudeSampler(m1, p1, n_walkers=4096, key=14, device="cpu")
    s_got, ss_got = spin_x_correlation(smp, n_iterations=25, n_sweeps=2, n_warmup=150)
    np.testing.assert_allclose(s_got, want_s, atol=0.04)
    np.testing.assert_allclose(ss_got, want_ss, atol=0.05)


def test_tempered_estimator_vs_exact():
    """AmplitudeSampler(n_beta>1): the beta=1 readout reproduces the same
    |psi|^2 expectation values as plain sampling."""
    m1, p1 = _machine(7)
    p = _exact_probs(m1, p1)
    want_m1 = float((p * np.abs(_all_spins(N).mean(axis=1))).sum())
    smp = AmplitudeSampler(m1, p1, n_walkers=4096, key=21, n_beta=4, device="cpu")
    assert smp.n_walkers == 1024
    assert smp.spins.shape == (1024, N) and smp.lnpsi.shape == (1024,)
    torch.testing.assert_close(smp.spins, smp.state.cache.spins[::4])
    m1_got, _, _ = spontaneous_magnetization(smp, n_iterations=30, n_sweeps=2, n_warmup=150)
    assert abs(m1_got - want_m1) < 0.03, (m1_got, want_m1)


def test_correlation_ratio_vs_exact():
    m1, p1 = _machine(7)
    p = _exact_probs(m1, p1)
    s = _all_spins(N)
    ks = [np.pi, np.pi + 2 * np.pi / N]
    want = [float((p * np.abs(s @ np.exp(1j * k * np.arange(N))) ** 2).sum()) / N for k in ks]
    smp = AmplitudeSampler(m1, p1, n_walkers=4096, key=15, device="cpu")
    trials = structure_factor_trials(smp, ks, n_iterations=30, n_sweeps=2, n_warmup=150)
    assert trials.shape == (30, 2)
    np.testing.assert_allclose(trials.mean(axis=0), want, rtol=0.05)
    smp2 = AmplitudeSampler(m1, p1, n_walkers=4096, key=16, device="cpu")
    r, r_err, s_peak, s_nb = correlation_ratio(smp2, n_iterations=30, n_sweeps=2, n_warmup=150)
    assert abs(r - want[1] / want[0]) < max(5 * r_err, 0.05), (r, want, r_err)
    assert r_err < 0.05


# ---------------------------------------------------------------------------
# The estimator loop and the sampler's surface


@pytest.mark.parametrize("n_beta", [1, 2])
def test_run_estimator_chunked_matches_monolithic(n_beta):
    """A chunked run and an unchunked one from the same seed give the same
    per-iteration outputs, a non-dividing remainder chunk included; the
    pair estimator takes the same chunking."""
    machine, params = _machine(11)

    def accum(cache, lnpsi):
        return cache.spins.mean(), lnpsi.real.mean()

    def run(chunk):
        smp = AmplitudeSampler(machine, params, 64, key=5, n_beta=n_beta, device="cpu")
        smp.warm_up(10)
        return smp.run_estimator(accum, 20, n_sweeps=2, chunk=chunk)

    mono, chunked = run(0), run(7)  # 7+7+6
    for a, b in zip(mono, chunked):
        np.testing.assert_array_equal(a, b)
    assert mono[0].shape == (20,)

    def run_pair(chunk):
        s1 = AmplitudeSampler(machine, params, 64, key=5, n_beta=n_beta, device="cpu")
        s2 = AmplitudeSampler(machine, params, 64, key=9, n_beta=n_beta, device="cpu")
        s1.scan_chunk = chunk  # None falls back to the samplers' scan_chunk
        return run_pair_estimator(s1, s2, lambda c1, l1, c2, l2: (l1.real - l2.real).mean(), 20, n_sweeps=1)

    np.testing.assert_array_equal(run_pair(0), run_pair(8))
    assert run_pair(0).shape == (20,)


def test_spin_x_correlation_chunked_matches_unchunked(monkeypatch):
    """The site-chunked flip-ratio path equals the single-shot tensor on the
    same sampler state and seed (the chunk cap forced to one site)."""
    m1, p1 = _machine(4)
    s_a, ss_a = spin_x_correlation(AmplitudeSampler(m1, p1, n_walkers=512, key=44, device="cpu"), 5, 1, 30)
    monkeypatch.setattr(est, "_FLIP_CHUNK_ELEMS", 1)
    s_b, ss_b = spin_x_correlation(AmplitudeSampler(m1, p1, n_walkers=512, key=44, device="cpu"), 5, 1, 30)
    np.testing.assert_allclose(s_b, s_a, rtol=0, atol=1e-10)
    np.testing.assert_allclose(ss_b, ss_a, rtol=0, atol=1e-10)


def test_amplitude_sampler_surface():
    """The JAX package's errors; the initial spins from init_spins; ln psi
    on fixed spins; an odd ladder (n_beta = 3) keeps whole replica groups."""
    m1, p1 = _machine(0)
    with pytest.raises(ValueError, match="multiple of n_beta"):
        AmplitudeSampler(m1, p1, 10, n_beta=4, device="cpu")
    with pytest.raises(ValueError, match="float32"):
        AmplitudeSampler(m1, p1, 8, use_fused=True, device="cpu")
    with pytest.raises(ValueError, match="whole replica groups"):  # meshes: tests/test_torch_mesh_drivers.py
        AmplitudeSampler(m1, p1, 8, n_beta=2, mesh=make_mesh(8, device="cpu"))
    one, two = (AmplitudeSampler(m1, p1, 8, key=3, **kw) for kw in ({"device": "cpu"},
                                                                      {"mesh": make_mesh(2, device="cpu")}))
    one.do_mcmc_steps(3)
    two.do_mcmc_steps(3)
    assert torch.equal(two.spins, one.spins)  # a mesh makes one device's decisions
    neel = np.tile(np.where(np.arange(N) % 2 == 0, 1.0, -1.0), (8, 1))
    smp = AmplitudeSampler(m1, p1, 8, init_spins=torch.as_tensor(neel), device="cpu")
    np.testing.assert_array_equal(smp.spins.numpy(), neel)
    torch.testing.assert_close(smp.log_psi(smp.spins), smp.lnpsi, rtol=0, atol=1e-12)
    assert smp.n_inputs == N and smp.n_walkers == 8
    m32 = RBM(n_inputs=6, n_hiddens=8, dtype=torch.float32)
    smp = AmplitudeSampler(m32, m32.init_params(make_generator(0, "cpu")), 384, key=1, n_beta=3, use_fused=True,
                           device="cpu")
    smp.do_mcmc_steps(2)
    assert torch.isfinite(smp.lnpsi.real).all() and smp.spins.shape[0] == 128
