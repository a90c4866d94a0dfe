"""PyTorch port vs the JAX package: the FFNN family and the bias-free RBMs
through the kernels' plain versions and through VMC.

The plain exchange is held to the JAX package's ``_exchange_scan`` decision
for decision (float64); the plain sweep keeps its cache consistent (as the
JAX package's tests/test_pallas.py:34) and samples |psi|^2 (as its
tests/test_pallas.py:63); the megakernel refuses output weights, as JAX's;
one SR update matches the JAX package's at 1e-8 in float64; a short
FFNNTrSymm training reaches the TFI chain's ground state. The CUDA kernels'
instances with output weights are held to these plain versions in
test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_network_quantum_state_tpu import models as jmodels
from neural_network_quantum_state_tpu.hamiltonians import HubbardChain as JHubbardChain
from neural_network_quantum_state_tpu.hamiltonians import LITFIChain as JLITFIChain
from neural_network_quantum_state_tpu.ops import cplx as jcplx
from neural_network_quantum_state_tpu.ops import engine as jengine
from neural_network_quantum_state_tpu.ops.cplx import C
from neural_network_quantum_state_tpu.optim import sr as jsr
from neural_network_quantum_state_tpu.sampler import kawasaki as jkawasaki
from neural_network_quantum_state_tpu.utils.exact import ground_energy, tfi_chain_dense
from neural_network_quantum_state_tpu_torch import VMC, VMCConfig
from neural_network_quantum_state_tpu_torch import models as tmodels
from neural_network_quantum_state_tpu_torch.hamiltonians import HubbardChain, LITFIChain, TFIChain
from neural_network_quantum_state_tpu_torch.models import params_from_jax
from neural_network_quantum_state_tpu_torch.ops import engine
from neural_network_quantum_state_tpu_torch.ops import exchange as exchange_ops
from neural_network_quantum_state_tpu_torch.ops import sweep_energy
from neural_network_quantum_state_tpu_torch.ops.rng import make_generator
from neural_network_quantum_state_tpu_torch.optim import sr
from neural_network_quantum_state_tpu_torch.sampler import chain_checkerboard, init_state, sweeps


def _np(c):
    return np.asarray(c.re) + 1j * np.asarray(c.im)


def _c(x):
    return C(jnp.asarray(np.real(x)), jnp.asarray(np.imag(x)))


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _pair(kind, n, dtype_j=jnp.float64, dtype_t=torch.float64, **kw):
    return (jmodels.get_machine(kind, n_inputs=n, dtype=dtype_j, **kw),
            tmodels.get_machine(kind, n_inputs=n, dtype=dtype_t, **kw))


def _params(jm, rng, scale=0.3):
    return {name: scale * (rng.normal(size=s) + 1j * rng.normal(size=s)) for name, s in jm.param_spec()}


def _sector_spins(rng, k, l, n_up, n_down):
    out = -np.ones((k, 2 * l))
    for w in range(k):
        out[w, rng.permutation(l)[:n_up]] = 1.0
        out[w, l + rng.permutation(l)[:n_down]] = 1.0
    return out


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("per_flavor_rings", [True, False], ids=["two-rings", "one-ring"])
def test_exchange_plain_matches_jax_ffnn(per_flavor_rings, rng):
    """The plain exchange rounds of a plain FFNN (every output weight
    distinct) against the JAX package's _exchange_scan on the same
    uniforms, float64: the same decisions, acceptance count, y, sa and
    ln psi, and the particle sectors kept."""
    l, h, k, n_steps = 8, 16, 256, 48
    jm, tm = _pair("FFNN", 2 * l, n_hiddens=h)
    p_np = _params(jm, rng)
    jwork = jm.make_work({name: _c(v) for name, v in p_np.items()})
    work = tm.make_work(params_from_jax(tm, p_np, device="cpu"))
    ham = HubbardChain(n_sites=2 * l, n_up=3, n_down=4, per_flavor_rings=per_flavor_rings)
    spins = _sector_spins(rng, k, l, 3, 4)
    u_sel, u_acc = rng.random((n_steps, k)), rng.random((n_steps, k))
    jcache, jln = jengine.full_forward(jwork, jnp.asarray(spins))
    jc2, jl2, jacc = jkawasaki._exchange_scan(jwork, jcache, jln, jnp.asarray(ham.bonds), jnp.asarray(u_sel), jnp.asarray(u_acc))
    cache, ln = engine.full_forward(work, _t(spins))
    c2, l2, acc = exchange_ops.exchange_plain(work, cache, ln, _t(ham.bonds), _t(u_sel), _t(u_acc))
    np.testing.assert_array_equal(c2.spins.numpy(), np.asarray(jc2.spins))
    assert float(acc) == float(jacc) > 0
    np.testing.assert_allclose(c2.y.numpy(), _np(jc2.y), rtol=0, atol=1e-10)
    np.testing.assert_allclose(c2.sa.numpy(), _np(jc2.sa), rtol=0, atol=1e-10)
    np.testing.assert_allclose(l2.numpy(), _np(jl2), rtol=0, atol=1e-10)
    s = c2.spins.numpy()
    if per_flavor_rings:
        assert ((s[:, :l] > 0).sum(1) == 3).all() and ((s[:, l:] > 0).sum(1) == 4).all()
    else:
        assert ((s > 0).sum(1) == 7).all()


@pytest.mark.parametrize(
    "kind, kw",
    [("RBMSfSymm", dict(alpha=2)), ("RBMZ2PrSymm", dict(alpha=3)), ("FFNN", dict(n_hiddens=12)),
     ("FFNNTrSymm", dict(alpha=2)), ("FFNNSfSymm", dict(alpha=2))],
    ids=["RBMSfSymm", "RBMZ2PrSymm", "FFNN", "FFNNTrSymm", "FFNNSfSymm"],
)
def test_sweeps_keep_the_cache_consistent(kind, kw):
    """float32, the machine's initial parameters, N=16, K=128: after 5
    sweeps the carried y and ln psi agree with a fresh forward of the final
    spins (the JAX package's tests/test_pallas.py:34 tolerances: y 2e-5,
    ln psi 2e-4)."""
    n, k = 16, 128
    tm = tmodels.get_machine(kind, n_inputs=n, dtype=torch.float32, **kw)
    g = make_generator(0, "cpu")
    work = tm.make_work(tm.init_params(g))
    state = init_state(work, torch.where(torch.rand((k, n), generator=g) < 0.5, -1.0, 1.0), g)
    state = sweeps(work, state, torch.as_tensor(chain_checkerboard(n)), 5)
    assert 0 < float(state.n_accepted) < float(state.n_proposed)
    fresh, ln = engine.full_forward(work, state.cache.spins)
    torch.testing.assert_close(state.cache.y, fresh.y, rtol=0, atol=2e-5)
    torch.testing.assert_close(state.cache.sa, fresh.sa, rtol=0, atol=2e-5)
    torch.testing.assert_close(state.lnpsi, ln, rtol=0, atol=2e-4)
    assert bool((state.cache.spins.abs() == 1.0).all())


def test_ffnn_sweeps_sample_psi2():
    """The sweeps of an FFNN (accept chain on Re(c ln cosh), both planes)
    sample |psi|^2: chi^2 and total variation against exact enumeration at
    N=4, H=8, with the JAX package's initial parameters scaled by 1.5, as
    its tests/test_pallas.py:63 (at 4 even exact sampling goes metastable)."""
    n, k = 4, 1024
    jm, tm = _pair("FFNN", n, jnp.float32, torch.float32, n_hiddens=8)
    jp = jm.init_params(jax.random.PRNGKey(2))
    tp = params_from_jax(tm, {name: 1.5 * _np(v) for name, v in jp.items()}, device="cpu")
    work = tm.make_work(tp)
    g = make_generator(3, "cpu")
    state = init_state(work, torch.where(torch.rand((k, n), generator=g) < 0.5, -1.0, 1.0), g)
    sched = torch.as_tensor(chain_checkerboard(n))

    confs = np.array([[1.0 - 2.0 * ((i >> b) & 1) for b in range(n)] for i in range(2**n)])
    t64 = tmodels.FFNN(n_inputs=n, n_hiddens=8, dtype=torch.float64)
    ln = engine.log_psi(t64.make_work(params_from_jax(t64, {k_: v.numpy() for k_, v in tp.items()}, device="cpu")),
                        _t(confs))
    p = np.exp(2.0 * ln.real.numpy())
    p /= p.sum()

    state = sweeps(work, state, sched, 30)
    counts = np.zeros(2**n)
    bit_w = np.asarray([1 << b for b in range(n)])
    for _ in range(40):
        state = sweeps(work, state, sched, 2)
        idx = ((1.0 - state.cache.spins.numpy()) / 2.0 @ bit_w).astype(int)
        counts += np.bincount(idx, minlength=2**n)
    total = counts.sum()
    chi2 = float(np.sum((counts - total * p) ** 2 / (total * p)))
    tv = 0.5 * float(np.abs(counts / total - p).sum())
    assert chi2 / (2**n - 1) < 3.0, (chi2, tv)
    assert tv < 0.03, tv
    assert p.max() > 4 * p.min()  # the target is far from uniform


def test_megakernel_refuses_output_weights():
    """As the JAX package's (tests/test_pallas_sweep_energy.py:62), the
    fused sweep + energy covers the RBM family only: output weights c
    raise, on the CPU's plain version too, before anything runs."""
    n, k = 8, 32
    tm = tmodels.FFNN(n_inputs=n, n_hiddens=6, dtype=torch.float32)
    work = tm.make_work(tm.init_params(make_generator(0, "cpu")))
    cache, ln = engine.full_forward(work, torch.ones((k, n)))
    u = torch.rand((n, k))
    calls = sweep_energy.sweeps_offdiag_plain.calls
    for fn in (lambda: sweep_energy.sweeps_offdiag(work, cache, ln, torch.arange(n), u),
               lambda: sweep_energy.sweeps_offdiag_cuda(work, cache, torch.arange(n), u)):
        with pytest.raises(ValueError, match="RBM family"):
            fn()
    assert sweep_energy.sweeps_offdiag_plain.calls == calls


def _jax_step(jm, jh, jp, spins, step, lr, max_dx_norm=1.0):
    """The JAX package's SR update composed as its VMC step composes it;
    returns (new params, energy, F, iterations)."""
    jcache, jln = jengine.full_forward(jm.make_work(jp), jnp.asarray(spins))
    htilda = jh.local_energy(jm.make_work(jp), jcache, jln)
    o = jm.grad_log(jp, jcache)
    lam = jsr.lambda_schedule(step, dtype=jnp.float64)
    dx, jres = jsr.sr_cg_solve(o, htilda, lam, tol=1e-5, max_iters=min(1000, jm.n_vars))
    dx = dx * min(1.0, max_dx_norm / max(float(jnp.sqrt(jcplx.norm2(dx))), 1e-30))
    return jm.update_params(jp, dx, lr), _np(jsr.energy_and_rsd(htilda)[0]), _np(jsr.force_vector(o, htilda)[0]), int(jres.iterations)


@pytest.mark.parametrize("case", ["FFNNTrSymm-LITFI", "FFNN-Hubbard"])
def test_sr_update_matches_jax(case, rng):
    """Local energy + O_k + CG solve + trust region + update from the same
    spins and parameters, float64: the energy, the force F and the new
    parameters (so dx) against the JAX package's at 1e-8."""
    k, lr, step = 256, 2e-2, 0
    if case == "FFNNTrSymm-LITFI":
        n = 8
        jm, tm = _pair("FFNNTrSymm", n, alpha=2)
        kw = dict(n_sites=n, h=-0.4, j=0.9, alpha=2.0, pbc=True)
        jh, th = JLITFIChain(**kw), LITFIChain(**kw)
        spins = np.where(rng.random((k, n)) < 0.5, -1.0, 1.0)
    else:
        l = 6
        jm, tm = _pair("FFNN", 2 * l, n_hiddens=8)
        kw = dict(n_sites=2 * l, u=4.0, t=1.0, n_up=2, n_down=2, v=tuple(np.tile(0.05 * (np.arange(l) - 2.5) ** 2, 2)))
        jh, th = JHubbardChain(**kw), HubbardChain(**kw)
        spins = _sector_spins(rng, k, l, 2, 2)
    p_np = _params(jm, rng)
    jnew, jenergy, jforce, jiters = _jax_step(jm, jh, {name: _c(v) for name, v in p_np.items()}, spins, step, lr)

    vmc = VMC(tm, th, VMCConfig(n_walkers=k, learning_rate=lr), device="cpu")
    tp = params_from_jax(tm, p_np, device="cpu")
    cache, ln = engine.full_forward(tm.make_work(tp), _t(spins))
    force = sr.force_vector(tm.grad_log(tp, cache), th.local_energy(tm.make_work(tp), cache, ln))[0]
    np.testing.assert_allclose(force.numpy(), jforce, rtol=1e-8, atol=1e-8)
    new, stats = vmc.sr_update(tp, cache, ln, step)
    assert stats.cg_iters == jiters
    np.testing.assert_allclose(stats.energy.numpy(), jenergy, rtol=1e-8)
    for name in tp:
        np.testing.assert_allclose(new[name].numpy(), _np(jnew[name]), rtol=1e-8, atol=1e-8)
        assert not np.allclose(new[name].numpy(), p_np[name])


def test_ffnn_trsymm_tfi_chain_converges_to_exact():
    """FFNNTrSymm(8, alpha=2) on the TFI chain, float64, K=256, lr 1e-2,
    200 warm-up sweeps and 400 SR steps, mean of the last 15. The JAX
    package's run of this configuration reaches 8.4e-6 to 4.7e-4 relative
    error against ED over seeds 11-14; the bar is four times its worst."""
    n = 8
    vmc = VMC(tmodels.FFNNTrSymm(n_inputs=n, alpha=2, dtype=torch.float64), TFIChain(n_sites=n, h=-1.0, j=-1.0),
              VMCConfig(n_walkers=256, learning_rate=1e-2, solver="cg", seed=11), device="cpu")
    params, state = vmc.init()
    state = vmc.warm_up(params, state, 200)
    params, state, history, _ = vmc.run(params, state, 400)
    e_exact = ground_energy(tfi_chain_dense(n, h=-1.0, j=-1.0))
    e_final = float(np.mean([h["energy"] for h in history[-15:]]))
    rel = abs(e_final - e_exact) / abs(e_exact)
    assert rel < 2e-3, (rel, e_final, e_exact)
