"""PyTorch port vs the JAX package: the dense solvers, the rest of the SR
module (dense, accumulated, minSR, sgd), MINRES and MINRES-QLP, on the same
numpy inputs (float64 on the CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_network_quantum_state_tpu.ops import cplx as jcplx
from neural_network_quantum_state_tpu.ops.cplx import C
from neural_network_quantum_state_tpu.optim import minres as jminres
from neural_network_quantum_state_tpu.optim import solvers as jsolvers
from neural_network_quantum_state_tpu.optim import sr as jsr
from neural_network_quantum_state_tpu_torch.optim import minres, solvers, sr


def _np(c):
    return np.asarray(c.re) + 1j * np.asarray(c.im)


def _c(x):
    return C(jnp.asarray(np.real(x)), jnp.asarray(np.imag(x)))


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _hpd(rng, v, shift=3.0):
    m = rng.normal(size=(v, v)) + 1j * rng.normal(size=(v, v))
    return m @ np.conj(m.T) + shift * np.eye(v)


def _rank_deficient(rng, v, r):
    m = rng.normal(size=(v, r)) + 1j * rng.normal(size=(v, r))
    return m @ np.conj(m.T)


def _o_and_e(rng, k=96, v=20):
    o = rng.normal(size=(k, v)) + 1j * rng.normal(size=(k, v)) + (0.3 - 0.1j)
    e = -1.0 + 0.3 * rng.normal(size=k) + 0.05j * rng.normal(size=k)
    return o, e


@pytest.mark.parametrize("name", ["lu", "cholesky", "svd"])
def test_dense_solvers_match_jax(name, rng):
    """The native complex solves equal JAX's real-embedding solves."""
    s, f = _hpd(rng, 24), rng.normal(size=24) + 1j * rng.normal(size=24)
    want = _np(jsolvers.SOLVERS[name](_c(s), _c(f)))
    got = solvers.SOLVERS[name](_t(s), _t(f)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(got, np.linalg.solve(s, f), rtol=1e-10, atol=1e-10)


def test_svd_drops_the_same_directions_on_a_rank_deficient_s(rng):
    """On a rank-deficient S the cutoff rcond * max drops the null space in
    both packages: the pseudo-inverse solution of each."""
    s = _rank_deficient(rng, 20, 11)
    f = rng.normal(size=20) + 1j * rng.normal(size=20)
    want = _np(jsolvers.svd_lstsq(_c(s), _c(f)))
    got = solvers.svd_lstsq(_t(s), _t(f)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(got, np.linalg.pinv(s, rcond=1e-10, hermitian=True) @ f, rtol=1e-8, atol=1e-10)


def test_cholesky_of_an_indefinite_matrix_gives_nan():
    """As JAX's cho_factor: no exception, a non-finite solution (which the
    VMC's trust region turns into a skipped update)."""
    s = np.diag([1.0, -1.0, 2.0]).astype(complex)
    got = solvers.cholesky_solve(_t(s), _t(np.ones(3, complex)))
    assert not torch.isfinite(got.real).all()


@pytest.mark.parametrize("lam", [0.07, 50.0])
def test_build_s_regularize_and_dense_solve_match_jax(lam, rng):
    o, e = _o_and_e(rng)
    jf, ja = jsr.force_vector(_c(o), _c(e))
    js = jsr.build_s_matrix(_c(o), ja)
    s = sr.build_s_matrix(_t(o), _t(_np(ja)))
    np.testing.assert_allclose(s.numpy(), _np(js), rtol=1e-10, atol=1e-12)
    jreg = jsr._regularize_dense(js, jnp.asarray(lam))
    np.testing.assert_allclose(sr._regularize_dense(s, lam).numpy(), _np(jreg), rtol=1e-10, atol=1e-12)
    for name in ("lu", "cholesky", "svd"):
        want = _np(jsr.sr_dense_solve(_c(o), _c(e), jnp.asarray(lam), jsolvers.SOLVERS[name]))
        got = sr.sr_dense_solve(_t(o), _t(e), lam, solvers.SOLVERS[name]).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


def test_regularize_dense_ridges_a_zero_variance_direction(rng):
    """A zero column of O (a frozen parameter) leaves diag(S)_i = 0; the
    ridge keeps the scaled matrix solvable in both packages, with the same
    solution on the directions whose diag(S) > 0."""
    o, e = _o_and_e(rng, k=64, v=10)
    o[:, 3] = 0.0
    want = _np(jsr.sr_dense_solve(_c(o), _c(e), jnp.asarray(0.1), jsolvers.cholesky_solve))
    got = sr.sr_dense_solve(_t(o), _t(e), 0.1, solvers.cholesky_solve).numpy()
    assert np.isfinite(got).all()
    live = np.arange(10) != 3
    np.testing.assert_allclose(got[live], want[live], rtol=1e-10, atol=1e-10)


def test_accumulated_equals_pooled_and_jax(rng):
    """R rounds accumulated equal one dense solve over the pooled walkers,
    and JAX's accumulated solve."""
    rounds = [_o_and_e(rng, k=32, v=10) for _ in range(3)]
    lam = 0.07
    got = sr.sr_dense_solve_accumulated([(_t(o), _t(e)) for o, e in rounds], lam, solvers.lu_solve).numpy()
    pooled = sr.sr_dense_solve(_t(np.concatenate([o for o, _ in rounds])), _t(np.concatenate([e for _, e in rounds])),
                               lam, solvers.lu_solve).numpy()
    want = _np(jsr.sr_dense_solve_accumulated([(_c(o), _c(e)) for o, e in rounds], jnp.asarray(lam), jsolvers.lu_solve))
    np.testing.assert_allclose(got, pooled, rtol=1e-8)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("k, v", [(64, 24), (24, 64)], ids=["K>V", "V>K"])
def test_minsr_matches_jax_and_the_dense_solve_at_its_ridge(k, v, rng):
    o = rng.normal(size=(k, v)) + 1j * rng.normal(size=(k, v))
    e = rng.normal(size=k) + 0.1j * rng.normal(size=k)
    lam = 0.05
    dx, lam_abs = sr.sr_minsr_solve(_t(o), _t(e), lam)
    jdx, jlam = jsr.sr_minsr_solve(_c(o), _c(e), jnp.asarray(lam, jnp.float64))
    assert float(lam_abs) == pytest.approx(float(jlam), rel=1e-12)
    np.testing.assert_allclose(dx.numpy(), _np(jdx), rtol=1e-9, atol=1e-12)
    # the V-space oracle with the same isotropic ridge
    f, a_o = sr.force_vector(_t(o), _t(e))
    s = sr.build_s_matrix(_t(o), a_o) + float(lam_abs) * torch.eye(v, dtype=torch.complex128)
    ref = solvers.lu_solve(s, f)
    assert float((dx - ref).abs().norm() / ref.abs().norm()) < 1e-9


def test_sgd_diag_solve_matches_jax(rng):
    o, e = _o_and_e(rng)
    want = _np(jsr.sgd_diag_solve(_c(o), _c(e), jnp.asarray(0.3)))
    np.testing.assert_allclose(sr.sgd_diag_solve(_t(o), _t(e), 0.3).numpy(), want, rtol=1e-10, atol=1e-12)


def _indefinite(rng, v, gap=0.5):
    m = rng.normal(size=(v, v)) + 1j * rng.normal(size=(v, v))
    w, q = np.linalg.eigh((m + np.conj(m.T)) / 2)
    w = np.where(np.abs(w) < gap, np.sign(w + (w == 0)) * gap, w)
    return (q * w) @ np.conj(q.T)


def _eigvec_case(rng):
    v = 12
    m = rng.normal(size=(v, v)) + 1j * rng.normal(size=(v, v))
    herm = (m + np.conj(m.T)) / 2 + 5.0 * np.eye(v)
    return herm, np.linalg.eigh(herm)[1][:, 3]


# The cases of tests/test_minres.py: (name, A, b, max_iters)
def _minres_cases(rng):
    a_pd = _hpd(rng, 24)
    a_ind = _indefinite(rng, 20)
    a_sc = _rank_deficient(rng, 18, 11)
    a_si = _rank_deficient(rng, 16, 9)
    a_ev, b_ev = _eigvec_case(rng)
    cplx_vec = lambda v: rng.normal(size=v) + 1j * rng.normal(size=v)
    return {
        "pd": (a_pd, cplx_vec(24), 400),
        "indefinite": (a_ind, cplx_vec(20), 400),
        "singular-consistent": (a_sc, a_sc @ cplx_vec(18), 400),
        "singular-inconsistent": (a_si, cplx_vec(16), 32),
        "zero-rhs": (np.eye(8, dtype=complex), np.zeros(8, complex), 400),
        "eigenvector-rhs": (a_ev, b_ev, 400),
    }


CASES = ["pd", "indefinite", "singular-consistent", "singular-inconsistent", "zero-rhs", "eigenvector-rhs"]


def _run_both(solve_t, solve_j, a, b, tol, max_iters):
    res = solve_t(lambda x: _t(a) @ x, _t(b), tol=tol, max_iters=max_iters)
    jres = solve_j(lambda x: jcplx.matmul_cc(_c(a), x), _c(b), tol=tol, max_iters=max_iters)
    return res, jres


@pytest.mark.parametrize("case", CASES)
def test_minres_qlp_matches_jax_on_its_cases(case, rng):
    """MINRES-QLP: iteration counts within one of JAX's, solutions to 1e-8,
    and the minimum-length (pinv) solution on the singular cases."""
    a, b, max_iters = _minres_cases(rng)[case]
    res, jres = _run_both(minres.minres_qlp_solve, jminres.minres_qlp_solve, a, b, 1e-12, max_iters)
    assert abs(res.iterations - int(jres.iterations)) <= 1, (res.iterations, int(jres.iterations))
    np.testing.assert_allclose(res.x.numpy(), _np(jres.x), rtol=1e-8, atol=1e-8)
    if case.startswith("singular"):
        np.testing.assert_allclose(res.x.numpy(), np.linalg.pinv(a) @ b, rtol=1e-4, atol=1e-6)
    if case == "zero-rhs":
        assert res.iterations == 0 and float(res.x.abs().sum()) == 0.0


@pytest.mark.parametrize("case", ["pd", "indefinite", "zero-rhs", "eigenvector-rhs"])
def test_minres_matches_jax_on_its_cases(case, rng):
    """Plain MINRES on the nonsingular cases (and b = 0): JAX's iteration
    count within one, the solution to 1e-8."""
    a, b, max_iters = _minres_cases(rng)[case]
    res, jres = _run_both(minres.minres_solve, jminres.minres_solve, a, b, 1e-11, max_iters)
    assert abs(res.iterations - int(jres.iterations)) <= 1, (res.iterations, int(jres.iterations))
    np.testing.assert_allclose(res.x.numpy(), _np(jres.x), rtol=1e-8, atol=1e-8)
    if case != "zero-rhs":
        np.testing.assert_allclose(res.x.numpy(), np.linalg.solve(a, b), rtol=1e-6, atol=1e-8)


def test_sr_minres_matches_cg_and_jax(rng):
    o = rng.normal(size=(64, 12)) + 1j * rng.normal(size=(64, 12))
    e = rng.normal(size=64) + 0.1j * rng.normal(size=64)
    dx_m, res = minres.sr_minres_solve(_t(o), _t(e), 0.05, tol=1e-12, max_iters=500)
    dx_c, _ = sr.sr_cg_solve(_t(o), _t(e), 0.05, tol=1e-12, max_iters=500)
    np.testing.assert_allclose(dx_m.numpy(), dx_c.numpy(), rtol=1e-6, atol=1e-9)
    jdx, jres = jminres.sr_minres_solve(_c(o), _c(e), jnp.asarray(0.05), tol=1e-12, max_iters=500)
    assert abs(res.iterations - int(jres.iterations)) <= 1
    np.testing.assert_allclose(dx_m.numpy(), _np(jdx), rtol=1e-8, atol=1e-10)


def test_sr_cg_precond_diag_gives_the_same_solution(rng):
    """A replacement preconditioner diagonal changes the iterations, not the
    solution; with the same diagonal it matches JAX's solve."""
    o, e = _o_and_e(rng, k=64, v=12)
    ref, _ = sr.sr_cg_solve(_t(o), _t(e), 0.05, tol=1e-12, max_iters=500)
    smooth = 0.7 * torch.ones(12, dtype=torch.float64)
    got, res = sr.sr_cg_solve(_t(o), _t(e), 0.05, tol=1e-12, max_iters=500, precond_diag=smooth)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6, atol=1e-9)
    jdx, jres = jsr.sr_cg_solve(_c(o), _c(e), jnp.asarray(0.05), tol=1e-12, max_iters=500,
                                precond_diag=jnp.asarray(smooth.numpy()))
    assert res.iterations == int(jres.iterations)
    np.testing.assert_allclose(got.numpy(), _np(jdx), rtol=1e-8, atol=1e-10)
