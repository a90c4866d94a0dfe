"""PyTorch port vs the JAX package: every SR solver and precision mode of
VMCConfig - one SR update from the same parameters and spins against the
JAX package's step arithmetic, the diag(S) EMA, the large-V rule - and the
solvers end to end on the CPU."""

import dataclasses
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neural_network_quantum_state_tpu as jnqs
from neural_network_quantum_state_tpu.hamiltonians import HubbardChain as JHubbardChain
from neural_network_quantum_state_tpu.hamiltonians import LITFIChain as JLITFIChain
from neural_network_quantum_state_tpu.models import RBM as JRBM
from neural_network_quantum_state_tpu.models import RBMTrSymm as JRBMTrSymm
from neural_network_quantum_state_tpu.ops import cplx as jcplx
from neural_network_quantum_state_tpu.ops import engine as jengine
from neural_network_quantum_state_tpu.ops.cplx import C
from neural_network_quantum_state_tpu.optim import minres as jminres
from neural_network_quantum_state_tpu.optim import solvers as jsolvers
from neural_network_quantum_state_tpu.optim import sr as jsr
from neural_network_quantum_state_tpu.utils.exact import ground_energy, tfi_chain_dense
from neural_network_quantum_state_tpu_torch import VMC, VMCConfig
from neural_network_quantum_state_tpu_torch.hamiltonians import HubbardChain, LITFIChain, TFIChain
from neural_network_quantum_state_tpu_torch.models import RBM, RBMTrSymm, params_from_jax
from neural_network_quantum_state_tpu_torch.ops import engine
from neural_network_quantum_state_tpu_torch.optim import sr
from neural_network_quantum_state_tpu_torch.vmc import SOLVER_NAMES, wants_large_v_mixed_precision

SOLVERS = list(SOLVER_NAMES)
# (machine dtype, energy_dtype): the widened modes run a float32 machine, as
# their users do; the plain mode a float64 one, so that both packages' steps
# agree to float64 roundoff.
MODES = {
    "None": (torch.float64, None),
    "float64": (torch.float32, torch.float64),
    "compensated": (torch.float32, "compensated"),
}


def _np(c):
    return np.asarray(c.re) + 1j * np.asarray(c.im)


def _c(x, dtype=jnp.float64):
    return C(jnp.asarray(np.real(x), dtype), jnp.asarray(np.imag(x), dtype))


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_step(jm, jh, jp, spins, step, cfg, energy_dtype):
    """The JAX package's step arithmetic (vmc.py _build_step), composed from
    its functions: estimators in the energy dtype cast to float64, the
    solver, the trust region and the update. Returns (htilda, O, dx before
    the trust region, new params)."""
    rdt = jnp.float64 if jm.dtype == jnp.float64 else jnp.float32
    pe = jp
    if energy_dtype is not None:
        pe = {k: C(v.re.astype(jnp.float64), v.im.astype(jnp.float64)) for k, v in jp.items()}
    work = jm.make_work(pe)
    cache, ln = jengine.full_forward(work, jnp.asarray(spins, jnp.float64 if energy_dtype else rdt))
    if energy_dtype == "compensated":
        htilda = jh.local_energy(work, cache, ln, compensated=True)
    else:
        htilda = jh.local_energy(work, cache, ln)
    o_mat = jm.grad_log(pe, cache)
    f64 = lambda x: C(x.re.astype(jnp.float64), x.im.astype(jnp.float64))
    htilda, o_mat = f64(htilda), f64(o_mat)
    havg, _ = jsr.energy_and_rsd(htilda)
    lam = jsr.lambda_schedule(step, dtype=jnp.float64)
    cap = min(cfg.cg_max_iters, jm.n_vars)
    if cfg.solver == "cg":
        dx, _ = jsr.sr_cg_solve(o_mat, htilda, lam, tol=cfg.cg_tol, max_iters=cap)
    elif cfg.solver == "auto":
        dx, res = jsr.sr_cg_solve(o_mat, htilda, lam, tol=cfg.cg_tol, max_iters=cap)
        f_vec, _ = jsr.force_vector(o_mat, htilda)
        if int(res.iterations) >= cap and float(res.residual_norm2) >= cfg.cg_tol**2 * float(jcplx.norm2(f_vec)):
            dx, _ = jminres.sr_minres_solve(o_mat, htilda, lam, tol=cfg.cg_tol, max_iters=cfg.cg_max_iters)
    elif cfg.solver == "minresqlp":
        dx, _ = jminres.sr_minres_solve(o_mat, htilda, lam, tol=cfg.cg_tol, max_iters=cfg.cg_max_iters)
    elif cfg.solver == "minsr":
        dx, _ = jsr.sr_minsr_solve(o_mat, htilda, lam)
    elif cfg.solver == "sgd":
        dx = jsr.sgd_diag_solve(o_mat, htilda, lam)
    else:
        dx = jsr.sr_dense_solve(o_mat, htilda, lam, jsolvers.SOLVERS[cfg.solver])
    dx_full = dx
    dx = C(dx.re.astype(rdt), dx.im.astype(rdt))
    dx_norm = float(jnp.sqrt(jcplx.norm2(dx)))
    dx = dx * min(1.0, cfg.max_dx_norm / max(dx_norm, 1e-30))
    var = float(jnp.mean(jcplx.abs2(htilda)) - jcplx.abs2(havg))
    assert math.isfinite(float(havg.re)) and var > 0.0
    return htilda, o_mat, dx_full, jm.update_params(jp, dx, cfg.learning_rate)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("solver", SOLVERS)
def test_sr_update_matches_jax_step(solver, mode, rng):
    """From the same parameters and spins: the estimators at 1e-10 (the
    compensated mode at 1e-6: both packages take its log-cosh parts in
    float32, each library's own transcendentals, as the mode intends); the
    solution from the same estimators at 1e-8 (before the trust region);
    the new parameters to the machine's precision."""
    n, k, lr, step = 8, 128, 2e-2, 3
    tdt, edt = MODES[mode]
    jdt = jnp.float64 if tdt == torch.float64 else jnp.float32
    jm, tm = JRBMTrSymm(n_inputs=n, alpha=2, dtype=jdt), RBMTrSymm(n_inputs=n, alpha=2, dtype=tdt)
    jh = JLITFIChain(n_sites=n, h=-0.4, j=0.9, alpha=2.0, pbc=True)
    th = LITFIChain(n_sites=n, h=-0.4, j=0.9, alpha=2.0, pbc=True)
    p_np = {name: 0.3 * (rng.normal(size=s) + 1j * rng.normal(size=s)) for name, s in jm.param_spec()}
    if tdt == torch.float32:  # the values both packages hold
        p_np = {name: v.astype(np.complex64).astype(np.complex128) for name, v in p_np.items()}
    spins = np.where(rng.random((k, n)) < 0.5, -1.0, 1.0)
    cfg = VMCConfig(n_walkers=k, learning_rate=lr, solver=solver, energy_dtype=edt, max_dx_norm=0.05)
    jp = {name: _c(v, jdt) for name, v in p_np.items()}
    jht, jo, jdx, jnew = _jax_step(jm, jh, jp, spins, step, cfg, edt)

    vmc = VMC(tm, th, cfg, device="cpu")
    tp = params_from_jax(tm, p_np, device="cpu")
    cache, ln = engine.full_forward(tm.make_work(tp), _t(spins).to(tdt))
    ht, o = vmc.estimator_terms(tp, cache, ln)
    assert ht.dtype == o.dtype == torch.complex128
    e_tol = 1e-6 if edt == "compensated" else 1e-10
    np.testing.assert_allclose(ht.numpy(), _np(jht), rtol=e_tol, atol=e_tol)
    np.testing.assert_allclose(o.numpy(), _np(jo), rtol=1e-10, atol=1e-10)
    dx, _ = vmc._solve(_t(_np(jo)), _t(_np(jht)), sr.lambda_schedule(step), step, None)
    np.testing.assert_allclose(dx.numpy(), _np(jdx), rtol=1e-8, atol=1e-8 * float(np.abs(_np(jdx)).max()))
    new, stats = vmc.sr_update(tp, cache, ln, step)
    assert math.isfinite(float(stats.energy.real))
    tol = 1e-8 if tdt == torch.float64 else 1e-5 if edt == "compensated" else 2e-6
    for name in tp:
        np.testing.assert_allclose(new[name].numpy(), _np(jnew[name]), rtol=tol, atol=tol)


@pytest.mark.parametrize("start", [0, 4], ids=["from-step-0", "resumed"])
def test_precond_ema_recursion_matches_jax(start, rng):
    """The EMA carry starts at ones and is seeded with diag(S) at step 0 (a
    resumed run never reseeds it); each CG solve is preconditioned by it."""
    n, k, rho = 6, 64, 0.9
    vmc = VMC(RBM(n_inputs=n, n_hiddens=4, dtype=torch.float64), TFIChain(n_sites=n),
              VMCConfig(n_walkers=k, precond_ema=rho, cg_tol=1e-10), device="cpu")
    v = vmc.machine.n_vars
    ema = jnp.ones((v,), jnp.float64)
    for step in range(start, start + 3):
        o = rng.normal(size=(k, v)) + 1j * rng.normal(size=(k, v))
        e = rng.normal(size=k) + 0.1j * rng.normal(size=k)
        oj = _c(o)
        cur = jsr.sr_diag(oj, jcplx.cmean(oj, axis=0))
        ema = jnp.where(step == 0, cur, rho * ema + (1.0 - rho) * cur)
        lam = sr.lambda_schedule(step)
        dx, iters = vmc._solve(_t(o), _t(e), lam, step, None)
        np.testing.assert_allclose(vmc._diag_ema.numpy(), np.asarray(ema), rtol=1e-12)
        jdx, jres = jsr.sr_cg_solve(oj, _c(e), jnp.asarray(lam), tol=1e-10, max_iters=v, precond_diag=ema)
        assert iters == int(jres.iterations)
        np.testing.assert_allclose(dx.numpy(), _np(jdx), rtol=1e-8, atol=1e-12)
    if start > 0:
        assert not np.allclose(vmc._diag_ema.numpy(), np.asarray(cur))  # never seeded


@pytest.mark.parametrize("energy_dtype", [None, "float64", "compensated"])
@pytest.mark.parametrize("solver", SOLVERS)
def test_large_v_rule_matches_jax(solver, energy_dtype):
    """solve_dtype defaults to float64 exactly where JAX's does: a float32
    machine with V >= 500, a cg or auto solve and no energy_dtype."""
    jed = {"float64": jnp.float64}.get(energy_dtype, energy_dtype)
    ted = {"float64": torch.float64}.get(energy_dtype, energy_dtype)
    jv = jnqs.VMC(JRBM(n_inputs=16, n_hiddens=32, dtype=jnp.float32), jnqs.hamiltonians.TFIChain(n_sites=16),
                  jnqs.VMCConfig(n_walkers=16, solver=solver, energy_dtype=jed))
    tv = VMC(RBM(n_inputs=16, n_hiddens=32), TFIChain(n_sites=16),
             VMCConfig(n_walkers=16, solver=solver, energy_dtype=ted), device="cpu")  # V = 560
    want = jv.config.solve_dtype is not None
    assert (tv.config.solve_dtype == torch.float64) == want
    assert wants_large_v_mixed_precision(tv.machine, solver) == (solver in ("cg", "auto"))
    small = VMC(RBM(n_inputs=16, n_hiddens=4), TFIChain(n_sites=16), VMCConfig(solver=solver), device="cpu")
    assert small.config.solve_dtype is None


def test_config_validation_as_jax():
    m, ham = RBM(n_inputs=4, n_hiddens=4, dtype=torch.float64), TFIChain(n_sites=4)
    with pytest.raises(ValueError, match="dense solver"):
        VMC(m, ham, VMCConfig(solver="minsr", n_accumulations=2), device="cpu")
    with pytest.raises(ValueError, match="ising family"):
        VMC(m, HubbardChain(n_sites=4, n_up=1, n_down=1), VMCConfig(energy_dtype="compensated"), device="cpu")
    with pytest.raises(ValueError, match="ising family"):
        jnqs.VMC(JRBM(n_inputs=4, n_hiddens=4, dtype=jnp.float64), JHubbardChain(n_sites=4, n_up=1, n_down=1),
                 jnqs.VMCConfig(energy_dtype="compensated"))
    with pytest.raises(ValueError, match="solver"):
        VMC(m, ham, VMCConfig(solver="bkf"), device="cpu")
    for solver in SOLVERS:
        VMC(m, ham, VMCConfig(solver=solver, n_accumulations=2 if solver in ("lu", "cholesky", "svd") else 1),
            device="cpu")


def _final_energy(history, tail=20):
    return float(np.mean([h["energy"] for h in history[-tail:]]))


def test_dense_sr_converges():
    """The cholesky solver trains the N=6 TFI chain to exact (test_e2e.py)."""
    n = 6
    vmc = VMC(RBM(n_inputs=n, n_hiddens=12, dtype=torch.float64), TFIChain(n_sites=n, h=-1.0, j=-1.0),
              VMCConfig(n_walkers=256, learning_rate=1e-2, solver="cholesky", seed=2), device="cpu")
    params, state = vmc.init()
    state = vmc.warm_up(params, state, 150)
    params, state, history, _ = vmc.run(params, state, 300)
    e_exact = ground_energy(tfi_chain_dense(n, h=-1.0, j=-1.0))
    assert abs(_final_energy(history) - e_exact) / abs(e_exact) < 5e-3


def _tfi_vmc(solver="cg", **kw):
    n = 8
    return VMC(RBM(n_inputs=n, n_hiddens=16, dtype=torch.float32), TFIChain(n_sites=n, h=-1.0, j=-1.0),
               VMCConfig(n_walkers=256, learning_rate=1e-2, solver=solver, seed=7, **kw), device="cpu")


def _one_step(vmc, params, state):
    return vmc.step(params, state._replace(generator=torch.Generator().set_state(state.generator.get_state())), 0)


def test_auto_falls_back_and_equals_cg_when_cg_converges():
    """A 2-iteration CG cap hands the solve to MINRES-QLP (iterations > 2,
    one fallback counted); under a cap CG meets, auto is CG."""
    vmc = _tfi_vmc("auto", cg_max_iters=2)
    params, state = vmc.init()
    state = vmc.warm_up(params, state, 50)
    _, _, stats = _one_step(vmc, params, state)
    assert stats.cg_iters > 2 and vmc.n_qlp_fallbacks == 1 and math.isfinite(float(stats.energy.real))
    cg, auto = _tfi_vmc("cg", cg_max_iters=200), _tfi_vmc("auto", cg_max_iters=200)
    p1, _, s1 = _one_step(cg, params, state)
    p2, _, s2 = _one_step(auto, params, state)
    assert s1.cg_iters == s2.cg_iters and auto.n_qlp_fallbacks == 0
    torch.testing.assert_close(p1["w"], p2["w"], rtol=1e-6, atol=0)


def test_energy_dtype_float64_widens_the_estimators_only():
    """energy_dtype=float64: the stats in float64, the parameters and the
    sampler state stay float32 (test_mixed_precision.py)."""
    vmc = _tfi_vmc(energy_dtype=torch.float64)
    params, state = vmc.init()
    state = vmc.warm_up(params, state, 50)
    params, state, stats = vmc.step(params, state, 0)
    assert stats.energy.dtype == torch.complex128
    assert params["w"].dtype == torch.complex64 and state.cache.spins.dtype == torch.float32
    assert math.isfinite(float(stats.energy.real))


def test_compensated_local_energy_matches_float64_on_a_trained_state():
    """The compensated local energy of a trained N=64 deep-ordered state
    (|ln psi| > 30, where the plain float32 difference cancels) equals the
    float64 one to 1e-12, far closer than the plain float32 path, and
    equals the JAX package's compensated sum to the two packages' float32
    log-cosh parts."""
    from neural_network_quantum_state_tpu.models import RBMTrSymm as JM
    from neural_network_quantum_state_tpu.utils.checkpoint import load_reference_text

    prefix = os.path.join(os.path.dirname(__file__), "..", "runs", "RBMTrSymmLICH-L64NF4A2.5T1.57V9")
    n, k, th = 64, 64, 1.57
    jparams = load_reference_text(JM(n_inputs=n, alpha=4, dtype=jnp.float32), prefix)
    machine = RBMTrSymm(n_inputs=n, alpha=4, dtype=torch.float32)
    params = params_from_jax(machine, {kk: (np.asarray(v.re), np.asarray(v.im)) for kk, v in jparams.items()},
                             device="cpu")
    ham = LITFIChain(n_sites=n, h=-math.cos(th), j=math.sin(th), alpha=2.5, pbc=True)
    vmc = VMC(machine, ham, VMCConfig(n_walkers=k, seed=2), device="cpu")
    _, state = vmc.init()
    state = vmc.warm_up(params, state, 30)
    assert float(state.lnpsi.real.abs().max()) > 30.0
    e_f32 = ham.local_energy(machine.make_work(params), state.cache, state.lnpsi)
    p64 = {kk: v.to(torch.complex128) for kk, v in params.items()}
    w64 = machine.make_work(p64)
    c64, l64 = engine.full_forward(w64, state.cache.spins.double())
    e_comp = ham.local_energy(w64, c64, l64, compensated=True)
    e_f64 = ham.local_energy(w64, c64, l64)
    err_f32 = float((e_f32.real.double() - e_f64.real).abs().max())
    err_comp = float((e_comp.real - e_f64.real).abs().max())
    assert e_comp.dtype == torch.complex128
    assert err_comp < 1e-12 and err_comp < err_f32 / 50.0, (err_comp, err_f32)
    jh = JLITFIChain(n_sites=n, h=-math.cos(th), j=math.sin(th), alpha=2.5, pbc=True)
    jp64 = {kk: C(v.re.astype(jnp.float64), v.im.astype(jnp.float64)) for kk, v in jparams.items()}
    jw = JM(n_inputs=n, alpha=4, dtype=jnp.float32).make_work(jp64)
    jc, jl = jengine.full_forward(jw, jnp.asarray(c64.spins.numpy()))
    je = jh.local_energy(jw, jc, jl, compensated=True)
    # each package within 1e-12 of the float64 sum: within 2e-12 of each other
    np.testing.assert_allclose(e_comp.numpy(), _np(je), rtol=0, atol=2e-12)


def test_compensated_energy_dtype_end_to_end():
    """VMCConfig(energy_dtype='compensated') trains a small LITFI chain."""
    n = 8
    vmc = VMC(RBM(n_inputs=n, n_hiddens=16, dtype=torch.float32), LITFIChain(n_sites=n, h=-0.62, j=0.78, alpha=2.5),
              VMCConfig(n_walkers=256, learning_rate=1e-2, energy_dtype="compensated", seed=9), device="cpu")
    params, state = vmc.init()
    state = vmc.warm_up(params, state, 100)
    params, state, hist, _ = vmc.run(params, state, 120)
    assert np.isfinite(hist[-1]["energy"]) and hist[-1]["energy"] < hist[0]["energy"]


def test_accumulated_dense_with_tempering_converges():
    """n_accumulations=3 with n_beta=4: each round reads its beta = 1
    replicas; <H> pools the rounds (test_parity_extras.py)."""
    n = 6
    vmc = VMC(RBM(n_inputs=n, n_hiddens=10, dtype=torch.float64), TFIChain(n_sites=n, h=-1.0, j=-1.0),
              VMCConfig(n_walkers=256, learning_rate=1e-2, solver="cholesky", n_accumulations=3, n_beta=4, seed=6),
              device="cpu")
    seen = []
    sr_update = vmc.sr_update

    def spy(params, cache, lnpsi, step_idx, extra_rounds=()):
        seen.append((cache.spins.shape[0], [c.spins.shape[0] for c, _ in extra_rounds]))
        return sr_update(params, cache, lnpsi, step_idx, extra_rounds=extra_rounds)

    vmc.sr_update = spy
    params, state = vmc.init()
    state = vmc.warm_up(params, state, 100)
    params, state, hist, _ = vmc.run(params, state, 250)
    assert seen[0] == (64, [64, 64])
    e_exact = ground_energy(tfi_chain_dense(n, h=-1.0, j=-1.0))
    assert abs(_final_energy(hist) - e_exact) / abs(e_exact) < 1e-2


@pytest.mark.parametrize("solver", SOLVERS)
def test_fixed_seed_trace_is_deterministic(solver):
    """The same seed gives the same 5-step trace (test_golden.py), per solver."""
    def trace():
        vmc = VMC(RBM(n_inputs=6, n_hiddens=8, dtype=torch.float64), TFIChain(n_sites=6, h=-1.0, j=-1.0),
                  VMCConfig(n_walkers=128, learning_rate=1e-2, solver=solver, seed=1234), device="cpu")
        params, state = vmc.init()
        state = vmc.warm_up(params, state, 50)
        return [h["energy"] for h in vmc.run(params, state, 5)[2]]

    t1, t2 = trace(), trace()
    assert np.isfinite(t1).all()
    np.testing.assert_allclose(t1, t2, rtol=0, atol=0)
