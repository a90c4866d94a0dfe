"""PyTorch port vs the JAX package: the 2D lattices (square, triangular,
checkerboard J1-J2) and their site schedules - tables, diagonal and local
energies, the plain sweep decision for decision on the 2D schedules, and
the ground energies against exact diagonalization (float64 on the CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_network_quantum_state_tpu import hamiltonians as jham
from neural_network_quantum_state_tpu import models as jmodels
from neural_network_quantum_state_tpu.ops import engine as jengine
from neural_network_quantum_state_tpu.ops.cplx import C
from neural_network_quantum_state_tpu.sampler import metropolis as jmetropolis
from neural_network_quantum_state_tpu.sampler import schedule as jschedule
from neural_network_quantum_state_tpu_torch import VMC, VMCConfig
from neural_network_quantum_state_tpu_torch import hamiltonians as tham
from neural_network_quantum_state_tpu_torch import models as tmodels
from neural_network_quantum_state_tpu_torch.models import params_from_jax
from neural_network_quantum_state_tpu_torch.ops import engine
from neural_network_quantum_state_tpu_torch.ops import sweep as sweep_ops
from neural_network_quantum_state_tpu_torch.sampler import schedule as tschedule


def _np(c):
    return np.asarray(c.re) + 1j * np.asarray(c.im)


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# (registry name, constructor arguments) of each lattice case
LATTICES = {
    "chain": ("tfichain", dict(n_sites=8, h=-0.7, j=-1.0)),
    "square-L3": ("tfisq", dict(n_sites=9, h=-1.0, j=-1.0)),
    "square-L4": ("tfisq", dict(n_sites=16, h=-0.8, j=0.6)),
    "triangular-L3": ("tfitri", dict(n_sites=9, h=-2.0, j=1.0)),
    "triangular-L6": ("tfitri", dict(n_sites=36, h=-1.2, j=0.7)),
    "checkerboard-L4-pbc": ("tficheckerboard", dict(n_sites=16, h=-1.5, j1=-1.0, j2=0.3, pbc=True)),
    "checkerboard-L4-obc": ("tficheckerboard", dict(n_sites=16, h=-1.1, j1=0.8, j2=-0.4, pbc=False)),
}


def _pair(case):
    name, kw = LATTICES[case]
    return jham.REGISTRY[name](**kw), tham.REGISTRY[name](**kw)


def test_registry_names_match_jax():
    assert set(tham.REGISTRY) == set(jham.REGISTRY)


@pytest.mark.parametrize("l", [2, 3, 4, 5, 6, 9])
def test_schedules_equal_jax(l):
    for name in ("square_checkerboard", "triangular_threecolor"):
        got, want = getattr(tschedule, name)(l), getattr(jschedule, name)(l)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    for name in ("chain_checkerboard", "sequential"):
        np.testing.assert_array_equal(getattr(tschedule, name)(l * l), getattr(jschedule, name)(l * l))


@pytest.mark.parametrize("case", list(LATTICES))
def test_tables_and_schedule_equal_jax(case):
    jh, th = _pair(case)
    for got, want in zip(th._tables(), jh._tables()):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(th.schedule(), jh.schedule())


@pytest.mark.parametrize("case", list(LATTICES))
@pytest.mark.parametrize("kind", ["RBM", "FFNN"])
def test_diagonal_and_local_energies_match_jax(case, kind, rng):
    jh, th = _pair(case)
    n, k = th.n_sites, 48
    jm = jmodels.get_machine(kind, n_inputs=n, n_hiddens=6, dtype=jnp.float64)
    tm = tmodels.get_machine(kind, n_inputs=n, n_hiddens=6, dtype=torch.float64)
    p_np = {name: 0.3 * (rng.normal(size=s) + 1j * rng.normal(size=s)) for name, s in jm.param_spec()}
    spins = np.where(rng.random((k, n)) < 0.5, -1.0, 1.0)
    jp = {name: C(jnp.asarray(v.real), jnp.asarray(v.imag)) for name, v in p_np.items()}
    jwork = jm.make_work(jp)
    jcache, jln = jengine.full_forward(jwork, jnp.asarray(spins))
    work = tm.make_work(params_from_jax(tm, p_np, device="cpu"))
    cache, ln = engine.full_forward(work, _t(spins))
    np.testing.assert_allclose(th.diag_energy(_t(spins)).numpy(), np.asarray(jh.diag_energy(jnp.asarray(spins))),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(th.local_energy(work, cache, ln).numpy(), _np(jh.local_energy(jwork, jcache, jln)),
                               rtol=1e-10, atol=1e-10)
    # the compensated sum takes its log-cosh parts in float32 (about 1e-7 of
    # each unit's difference, H of them per site): near the float64 one, and
    # on one lattice near JAX's (slow in JAX's eager mode; with output
    # weights c its compensated sum calls a cplx.cmul the JAX package lacks)
    comp = th.local_energy(work, cache, ln, compensated=True)
    np.testing.assert_allclose(comp.numpy(), th.local_energy(work, cache, ln).numpy(), rtol=1e-5, atol=1e-5)
    if kind == "RBM" and case == "checkerboard-L4-pbc":
        np.testing.assert_allclose(comp.numpy(), _np(jh.local_energy(jwork, jcache, jln, compensated=True)),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["square-L4", "triangular-L6", "checkerboard-L4-pbc"])
@pytest.mark.parametrize("kind", ["RBM", "FFNN"])
def test_plain_sweep_on_2d_schedules_matches_jax_decision_for_decision(case, kind, rng):
    """The plain sweep over a 2D schedule, against JAX's _sweep_scan on the
    same numpy uniforms: the same spins, and y, sa, ln psi to 1e-10."""
    _, th = _pair(case)
    n, k, n_sweeps = th.n_sites, 64, 2
    jm = jmodels.get_machine(kind, n_inputs=n, n_hiddens=8, dtype=jnp.float64)
    tm = tmodels.get_machine(kind, n_inputs=n, n_hiddens=8, dtype=torch.float64)
    p_np = {name: 0.4 * (rng.normal(size=s) + 1j * rng.normal(size=s)) for name, s in jm.param_spec()}
    spins = np.where(rng.random((k, n)) < 0.5, -1.0, 1.0)
    sched = th.schedule()
    uniforms = rng.random((n_sweeps * n, k))
    jwork = jm.make_work({name: C(jnp.asarray(v.real), jnp.asarray(v.imag)) for name, v in p_np.items()})
    jcache, jln = jengine.full_forward(jwork, jnp.asarray(spins))
    jc2, jl2, jacc = jmetropolis._sweep_scan(jwork, jcache, jln, jnp.asarray(np.tile(sched, n_sweeps)),
                                             jnp.asarray(uniforms))
    work = tm.make_work(params_from_jax(tm, p_np, device="cpu"))
    cache, ln = engine.full_forward(work, _t(spins))
    c2, l2, acc = sweep_ops.sweep_plain(work, cache, ln, _t(sched), _t(uniforms))
    np.testing.assert_array_equal(c2.spins.numpy(), np.asarray(jc2.spins))
    np.testing.assert_allclose(c2.y.numpy(), _np(jc2.y), rtol=0, atol=1e-10)
    np.testing.assert_allclose(c2.sa.numpy(), _np(jc2.sa), rtol=0, atol=1e-10)
    np.testing.assert_allclose(l2.numpy(), _np(jl2), rtol=0, atol=1e-10)
    assert float(acc) == float(jacc) > 0


def _ed_parts(th):
    """The exact Hamiltonian (sparse) from the lattice's own neighbour
    tables, in the basis s_i = 1 - 2 bit_i of the index, and its spins."""
    import scipy.sparse as sp

    nnidx, jmat = th._tables()
    n = th.n_sites
    jfull = np.zeros((n, n))
    for i in range(n):
        for a, jv in zip(nnidx[i], jmat[i]):
            jfull[i, a] += jv
    dim = 2**n
    idx = np.arange(dim)
    s = 1.0 - 2.0 * ((idx[:, None] >> np.arange(n)[None, :]) & 1)
    rows, cols, vals = [idx], [idx], [0.5 * np.einsum("ki,ij,kj->k", s, jfull, s)]
    for i in range(n):
        rows.append(idx)
        cols.append(idx ^ (1 << i))
        vals.append(np.full(dim, th.h))
    hmat = sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))), shape=(dim, dim))
    return hmat, s


def _ed_energy(th):
    import scipy.sparse.linalg as spl

    return float(spl.eigsh(_ed_parts(th)[0], k=1, which="SA", return_eigenvectors=False)[0])


@pytest.mark.parametrize("case", ["square-L3", "square-L4", "triangular-L3", "checkerboard-L4-pbc",
                                  "checkerboard-L4-obc"])
def test_local_energy_averages_to_the_exact_hamiltonian(case, rng):
    """Over all 2^N configurations, sum |psi|^2 E_loc / sum |psi|^2 with the
    port's local energy equals <psi|H|psi> / <psi|psi> with the exact
    Hamiltonian at the JAX tests' sizes, and lies above its ground energy."""
    _, th = _pair(case)
    hmat, s = _ed_parts(th)
    tm = tmodels.RBM(n_inputs=th.n_sites, n_hiddens=6, dtype=torch.float64)
    p_np = {name: 0.3 * (rng.normal(size=sh) + 1j * rng.normal(size=sh)) for name, sh in tm.param_spec()}
    work = tm.make_work(params_from_jax(tm, p_np, device="cpu"))
    cache, ln = engine.full_forward(work, _t(s))
    e_loc = th.local_energy(work, cache, ln).numpy()
    w = np.exp(2.0 * (ln.real.numpy() - ln.real.numpy().max()))
    psi = np.exp(ln.numpy() - ln.real.numpy().max())
    e_port = (w * e_loc).sum() / w.sum()
    e_ed = np.vdot(psi, hmat @ psi) / np.vdot(psi, psi)
    np.testing.assert_allclose(e_port, e_ed, rtol=1e-10, atol=1e-10)
    assert e_port.real >= _ed_energy(th) - 1e-9


@pytest.mark.parametrize(
    "ham, hidden, iters, lr, solver, tol",
    [
        (tham.TFISQ(n_sites=4, h=-1.0, j=-1.0), 8, 400, 1e-2, "cg", 5e-3),
        (tham.TFITRI(n_sites=9, h=-2.0, j=1.0), 18, 250, 2e-2, "lu", 1e-2),
        (tham.TFICheckerBoard(n_sites=16, h=-1.5, j1=-1.0, j2=0.3, pbc=True), 16, 250, 2e-2, "lu", 1e-2),
    ],
    ids=["square-L2", "triangular-L3", "checkerboard-L4"],
)
def test_vmc_reaches_exact_ground_energy(ham, hidden, iters, lr, solver, tol):
    """The 2D lattices of tests/test_lattices_2d.py trained by the port to
    their exact ground energies, at the JAX tests' sizes and tolerances
    (the dense LU solve where it converges in fewer steps than CG)."""
    vmc = VMC(tmodels.RBM(n_inputs=ham.n_sites, n_hiddens=hidden, dtype=torch.float64), ham,
              VMCConfig(n_walkers=256, learning_rate=lr, solver=solver, seed=3), device="cpu")
    params, state = vmc.init()
    state = vmc.warm_up(params, state, 150)
    params, state, hist, _ = vmc.run(params, state, iters)
    e = float(np.mean([x["energy"] for x in hist[-30:]]))
    e_exact = _ed_energy(ham)
    assert abs(e - e_exact) / abs(e_exact) < tol, (e, e_exact)
