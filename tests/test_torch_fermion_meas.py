"""PyTorch port vs the JAX package: the fermion measurements
(``measurements/fermion.py``).

Deterministic parity: the pair-OPDM body (m = 0, m > 0 with and without a
Jordan-Wigner string) and the density body on the same spins and
parameters in both packages, at 1e-10 in float64 and 1e-5 in float32.

Statistics: the cases of the JAX package's tests/test_fermion_meas.py
(the OPDM against the exact sector-restricted expectation, sector
conservation, a chunked run against an unchunked one) and of
tests/test_tempered_exchange.py (the tempered sampler's density profile
against the untempered one), at their bars.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_network_quantum_state_tpu.measurements import fermion as jfermion
from neural_network_quantum_state_tpu.models import RBM as JRBM
from neural_network_quantum_state_tpu.ops import engine as jengine
from neural_network_quantum_state_tpu.ops.cplx import C
from neural_network_quantum_state_tpu_torch.measurements import FermionAmplitudeSampler, opdm_pair
from neural_network_quantum_state_tpu_torch.measurements import fermion
from neural_network_quantum_state_tpu_torch.models import RBM, params_from_jax
from neural_network_quantum_state_tpu_torch.ops import engine
from neural_network_quantum_state_tpu_torch.ops.rng import make_generator
from neural_network_quantum_state_tpu_torch.parallel import make_mesh

L = 3  # 6 JW spins, as the JAX package's tests
N_UP = N_DN = 2


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _machine(seed, h=10, dtype=torch.float64):
    m = RBM(n_inputs=2 * L, n_hiddens=h, dtype=dtype)
    return m, m.init_params(make_generator(seed, "cpu"))


class _Stub:
    """A fermion sampler with one fixed state: run_estimator evaluates the
    body once and returns its outputs as two identical iterations."""

    def __init__(self, pkg, machine, params, spins, l):
        self.work, self.l, self.outputs = machine.make_work(params), l, None
        if pkg == "jax":
            self.cache, self.lnpsi = jengine.full_forward(self.work, jnp.asarray(spins, machine.real_dtype))
        else:
            self.cache, self.lnpsi = engine.full_forward(self.work, torch.as_tensor(spins, dtype=machine.dtype))
        self.device = torch.device("cpu")

    def warm_up(self, n):
        pass

    def run_estimator(self, accum, n_iterations, n_sweeps=1, chunk=None):
        out = accum(self.cache, self.lnpsi)
        self.outputs = [np.asarray(x) for x in (out if isinstance(out, tuple) else (out,))]
        return jax.tree_util.tree_map(lambda x: np.repeat(np.asarray(x)[None], 2, 0), out)


def _sector_spins(rng, k, l, n_up, n_down):
    out = -np.ones((k, 2 * l))
    for w in range(k):
        out[w, rng.permutation(l)[:n_up]] = 1.0
        out[w, l + rng.permutation(l)[:n_down]] = 1.0
    return out


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("what", ["opdm-0-0", "opdm-0-1", "opdm-1-3", "opdm-2-0", "density"])
def test_fermion_bodies_match_jax(what, dtype):
    """The per-iteration bodies on the same in-sector spins of an L = 5
    chain (the m = 3 row crosses a two-site Jordan-Wigner string)."""
    l, tol = 5, {torch.float64: 1e-10, torch.float32: 1e-5}[dtype]
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jm = JRBM(n_inputs=2 * l, n_hiddens=12, dtype=jdt)
    jp = {k: C(3.0 * v.re, 3.0 * v.im) for k, v in jm.init_params(jax.random.PRNGKey(8)).items()}
    tm = RBM(n_inputs=2 * l, n_hiddens=12, dtype=dtype)
    tp = params_from_jax(tm, {k: (np.asarray(v.re), np.asarray(v.im)) for k, v in jp.items()}, device="cpu")
    spins = _sector_spins(np.random.default_rng(2), 64, l, 2, 3)
    outs = []
    for pkg, mod, machine, params in (("jax", jfermion, jm, jp), ("torch", fermion, tm, tp)):
        stub = _Stub(pkg, machine, params, spins, l)
        if what == "density":
            mod.density_profile(stub, 2)
        else:
            _, n, m = what.split("-")
            mod.opdm_pair(stub, int(n), int(m), 2)
        outs.append(stub.outputs)
    want, got = outs
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)
    if what == "opdm-1-3":
        assert np.abs(want[0]) > 1e-3  # the row is not trivially zero


def _exact_opdm(machine, params, n, m):
    """Exact <Op> over the (N_UP, N_DN) sector in the estimator's
    matrix-element convention, psi from full enumeration."""
    n_in = 2 * L
    idx = np.arange(2**n_in)
    s = 1.0 - 2.0 * ((idx[:, None] >> np.arange(n_in)[None, :]) & 1)
    occ = (1 + s) / 2
    sector = (occ[:, :L].sum(1) == N_UP) & (occ[:, L:].sum(1) == N_DN)
    psi = np.exp(engine.log_psi(machine.make_work(params), torch.as_tensor(s)).numpy())
    psi = np.where(sector, psi, 0.0)
    p = np.abs(psi) ** 2
    p /= p.sum()
    if m == 0:
        return np.sum(p * 0.25 * (1 + s[:, n]) * (1 + s[:, L + n]))
    flipped = idx ^ ((1 << n) | (1 << (n + m)) | (1 << (L + n)) | (1 << (L + n + m)))
    string = np.prod(s[:, n + 1 : n + m] * s[:, L + n + 1 : L + n + m], axis=1)
    coeff = (1 / 16) * (1 + s[:, n + m]) * (1 + s[:, L + n + m]) * (1 - s[:, n]) * (1 - s[:, L + n]) * string
    ratio = np.where(np.abs(psi) > 0, psi[flipped] / np.where(psi == 0, 1.0, psi), 0.0)
    return np.sum(p * coeff * ratio)


def test_opdm_vs_exact():
    """The JAX package's (n, m) cases on one sampler, warmed once, as the
    driver's -what=opdm row runs them."""
    machine, params = _machine(4)
    smp = FermionAmplitudeSampler(machine, params, n_walkers=4096, n_up=N_UP, n_down=N_DN, key=21, device="cpu")
    for i, (n, m) in enumerate([(0, 0), (0, 1), (0, 2), (1, 1)]):
        want = _exact_opdm(machine, params, n, m)
        got = opdm_pair(smp, n, m, n_iterations=25, n_sweeps=2, n_warmup=150 if i == 0 else 0)
        assert abs(got.real - want.real) < 0.03, (n, m, got, want)
        assert abs(got.imag - want.imag) < 0.03, (n, m, got, want)


def test_fermion_sampler_conserves():
    machine, params = _machine(5, h=6)
    smp = FermionAmplitudeSampler(machine, params, n_walkers=64, n_up=1, n_down=2, key=3, device="cpu")
    smp.do_mcmc_steps(15)
    s = smp.spins.numpy()
    assert np.all(((1 + s[:, :L]) / 2).sum(1) == 1)
    assert np.all(((1 + s[:, L:]) / 2).sum(1) == 2)
    assert smp.bonds.shape == (2 * L, 2) and smp.n_unit_steps == 2 * L


def test_fermion_sampler_nbeta_matches_plain():
    """FermionAmplitudeSampler(n_beta=4): the density profile agrees with
    the untempered sampler's within MC error, every replica keeps its
    sector, and spins/lnpsi expose the beta=1 slice."""
    machine, params = _machine(4, h=8)
    f1 = FermionAmplitudeSampler(machine, params, 1024, 1, 1, key=5, device="cpu")
    f2 = FermionAmplitudeSampler(machine, params, 4096, 1, 1, key=6, n_beta=4, device="cpu")
    assert f2.spins.shape == (1024, 2 * L) and f2.lnpsi.shape == (1024,)
    d1 = fermion.density_profile(f1, 40, 2, 150)
    d2 = fermion.density_profile(f2, 40, 2, 150)
    assert abs(d1.sum() - 2.0) < 1e-5 and abs(d2.sum() - 2.0) < 1e-5
    np.testing.assert_allclose(d1, d2, atol=0.05)
    s = f2.state.cache.spins.numpy()
    assert np.all((s[:, :L] > 0).sum(1) == 1) and np.all((s[:, L:] > 0).sum(1) == 1)


def test_fermion_run_estimator_chunked_matches_monolithic():
    machine, params = _machine(3, h=8)

    def run(chunk):
        smp = FermionAmplitudeSampler(machine, params, n_walkers=64, n_up=N_UP, n_down=N_DN, key=7, device="cpu")
        smp.warm_up(10)
        return smp.run_estimator(lambda c, ln: (c.spins.mean(), ln.real.mean()), 15, n_sweeps=2, chunk=chunk)

    mono, chunked = run(0), run(4)  # 4+4+4+3
    for a, b in zip(mono, chunked):
        np.testing.assert_array_equal(a, b)
    assert mono[0].shape == (15,)


def test_fermion_sampler_refuses_what_the_jax_package_refuses():
    machine, params = _machine(0)
    with pytest.raises(ValueError, match="multiple of n_beta"):
        FermionAmplitudeSampler(machine, params, 10, 1, 1, n_beta=4, device="cpu")
    with pytest.raises(ValueError, match="tempered exchange"):
        FermionAmplitudeSampler(machine, params, 8, 1, 1, n_beta=2, use_fused=True, device="cpu")
    with pytest.raises(ValueError, match="float32"):
        FermionAmplitudeSampler(machine, params, 8, 1, 1, use_fused=True, device="cpu")
    with pytest.raises(ValueError, match="whole replica groups"):  # meshes: tests/test_torch_mesh_drivers.py
        FermionAmplitudeSampler(machine, params, 8, 1, 1, mesh=make_mesh(3, device="cpu"))
    one, two = (FermionAmplitudeSampler(machine, params, 8, 1, 1, key=3, **kw)
                for kw in ({"device": "cpu"}, {"mesh": make_mesh(2, device="cpu")}))
    one.do_mcmc_steps(3)
    two.do_mcmc_steps(3)
    assert torch.equal(two.spins, one.spins)  # a mesh makes one device's decisions
    odd = RBM(n_inputs=5, n_hiddens=4, dtype=torch.float64)
    with pytest.raises(ValueError, match="2L inputs"):
        FermionAmplitudeSampler(odd, odd.init_params(make_generator(0, "cpu")), 8, 1, 1, device="cpu")
    smp = FermionAmplitudeSampler(machine, params, 8, 1, 1, device="cpu")
    with pytest.raises(ValueError, match="must be < L"):
        opdm_pair(smp, 1, 2, 2)
