"""PyTorch port vs the JAX package: SR pieces, the CG solve and one whole
SR update from the same spins (float64 on the CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_network_quantum_state_tpu.hamiltonians import LITFIChain as JLITFIChain
from neural_network_quantum_state_tpu.models import RBMTrSymm as JRBMTrSymm
from neural_network_quantum_state_tpu.ops import cplx as jcplx
from neural_network_quantum_state_tpu.ops import engine as jengine
from neural_network_quantum_state_tpu.ops.cplx import C
from neural_network_quantum_state_tpu.optim import sr as jsr
from neural_network_quantum_state_tpu_torch import VMC, VMCConfig
from neural_network_quantum_state_tpu_torch.hamiltonians import LITFIChain
from neural_network_quantum_state_tpu_torch.models import RBMTrSymm, params_from_jax
from neural_network_quantum_state_tpu_torch.ops import engine
from neural_network_quantum_state_tpu_torch.optim import sr
from neural_network_quantum_state_tpu_torch.optim.cg import cg_solve


def _np(c):
    return np.asarray(c.re) + 1j * np.asarray(c.im)


def _c(x):
    return C(jnp.asarray(np.real(x)), jnp.asarray(np.imag(x)))


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _o_and_e(rng, k=200, v=30):
    """A sampled-looking O (K,V) and E (K,)."""
    o = rng.normal(size=(k, v)) + 1j * rng.normal(size=(k, v)) + (0.3 + 0.2j)
    e = -1.0 + 0.3 * rng.normal(size=k) + 0.05j * rng.normal(size=k)
    return o, e


def test_lambda_schedule_matches_jax():
    for step in (0, 1, 10, 43, 44, 200):
        assert sr.lambda_schedule(step) == pytest.approx(float(jsr.lambda_schedule(step, dtype=jnp.float64)), rel=1e-14)


def test_force_diag_energy_match_jax(rng):
    o, e = _o_and_e(rng)
    jf, ja = jsr.force_vector(_c(o), _c(e))
    f, a = sr.force_vector(_t(o), _t(e))
    np.testing.assert_allclose(f.numpy(), _np(jf), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(a.numpy(), _np(ja), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(sr.sr_diag(_t(o), a).numpy(), np.asarray(jsr.sr_diag(_c(o), ja)), rtol=1e-12, atol=1e-12)
    jh, jr = jsr.energy_and_rsd(_c(e))
    h, r = sr.energy_and_rsd(_t(e))
    np.testing.assert_allclose(h.numpy(), _np(jh), rtol=1e-12)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-12)


@pytest.mark.parametrize("lam", [100.0, 1e-2])
def test_sr_cg_solve_matches_jax(lam, rng):
    o, e = _o_and_e(rng)
    jx, jres = jsr.sr_cg_solve(_c(o), _c(e), jnp.asarray(lam), tol=1e-5, max_iters=30)
    x, res = sr.sr_cg_solve(_t(o), _t(e), lam, tol=1e-5, max_iters=30)
    assert res.iterations == int(jres.iterations)
    np.testing.assert_allclose(x.numpy(), _np(jx), rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("lam", [100.0, 1e-2])
def test_sr_cg_solve_matches_the_conj_transpose_matvec(lam, rng):
    """The solve forms O^H u as conj(conj(u) @ O) and F from conj(E) @ O,
    never conj(O); it is held to the form that took O^H = O.conj().T
    explicitly, in float64 at 1e-12, with the same iteration count."""
    o, e = _o_and_e(rng, k=300, v=40)
    o_t, e_t = _t(o), _t(e)
    k = o_t.shape[0]
    a_o = o_t.mean(0)
    f = (e_t @ o_t.conj()) / k - e_t.mean() * a_o.conj()
    diag = sr.sr_diag(o_t, a_o)
    o_h = o_t.conj().T

    def matvec(a):
        return (o_h @ (o_t @ a)) / k - a_o.conj() * (a_o @ a) + (lam * diag) * a

    floor = 1e-10 * diag.max() + torch.finfo(diag.dtype).tiny
    inv_pdiag = 1.0 / ((1.0 + lam) * torch.maximum(diag, floor))
    want = cg_solve(matvec, f, precond=lambda r: inv_pdiag * r, tol=1e-8, max_iters=40)
    x, res = sr.sr_cg_solve(o_t, e_t, lam, tol=1e-8, max_iters=40)
    assert res.iterations == want.iterations > 1
    np.testing.assert_allclose(sr.force_vector(o_t, e_t)[0].numpy(), f.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(x.numpy(), want.x.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("step, max_dx_norm", [(0, 1.0), (60, 0.05)], ids=["lambda100", "lambda-min-trust-region"])
def test_sr_update_matches_jax(step, max_dx_norm, rng):
    """local energy + O_k + CG solve + trust region + update, from the same
    spins and parameters, against the JAX package's functions composed as
    its VMC step composes them."""
    n, k, lr = 8, 256, 2e-2
    jm, tm = JRBMTrSymm(n_inputs=n, alpha=2, dtype=jnp.float64), RBMTrSymm(n_inputs=n, alpha=2, dtype=torch.float64)
    jh = JLITFIChain(n_sites=n, h=-0.4, j=0.9, alpha=2.0, pbc=True)
    th = LITFIChain(n_sites=n, h=-0.4, j=0.9, alpha=2.0, pbc=True)
    p_np = {name: 0.3 * (rng.normal(size=s) + 1j * rng.normal(size=s)) for name, s in jm.param_spec()}
    spins = np.where(rng.random((k, n)) < 0.5, -1.0, 1.0)

    jp = {name: _c(v) for name, v in p_np.items()}
    jcache, jln = jengine.full_forward(jm.make_work(jp), jnp.asarray(spins))
    htilda = jh.local_energy(jm.make_work(jp), jcache, jln)
    lam = jsr.lambda_schedule(step, dtype=jnp.float64)
    dx, jres = jsr.sr_cg_solve(jm.grad_log(jp, jcache), htilda, lam, tol=1e-5, max_iters=min(1000, jm.n_vars))
    dx_norm = float(jnp.sqrt(jcplx.norm2(dx)))
    dx = dx * min(1.0, max_dx_norm / max(dx_norm, 1e-30))
    jnew = jm.update_params(jp, dx, lr)

    vmc = VMC(tm, th, VMCConfig(n_walkers=k, learning_rate=lr, max_dx_norm=max_dx_norm), device="cpu")
    tp = params_from_jax(tm, p_np, device="cpu")
    cache, ln = engine.full_forward(tm.make_work(tp), _t(spins))
    new, stats = vmc.sr_update(tp, cache, ln, step)

    assert stats.cg_iters == int(jres.iterations)
    np.testing.assert_allclose(stats.energy.numpy(), _np(jsr.energy_and_rsd(htilda)[0]), rtol=1e-12)
    for name in tp:
        np.testing.assert_allclose(new[name].numpy(), _np(jnew[name]), rtol=1e-8, atol=1e-8)
        assert not np.allclose(new[name].numpy(), p_np[name]) or name == "a"
