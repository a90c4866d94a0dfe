"""PyTorch port vs the JAX package: Metropolis sweeps.

The plain sweep is held to the JAX package's ``metropolis._sweep_scan``
decision for decision on the same numpy uniforms (float64), and ``sweeps``
is held to exact |psi|^2 by chi^2 and total variation. The
CUDA kernel's tests are in test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_network_quantum_state_tpu.models import RBM as JRBM
from neural_network_quantum_state_tpu.models import RBMTrSymm as JRBMTrSymm
from neural_network_quantum_state_tpu.ops import engine as jengine
from neural_network_quantum_state_tpu.ops.cplx import C
from neural_network_quantum_state_tpu.sampler import metropolis as jmetropolis
from neural_network_quantum_state_tpu_torch.models import RBM, RBMTrSymm, params_from_jax
from neural_network_quantum_state_tpu_torch.ops import engine
from neural_network_quantum_state_tpu_torch.ops import sweep as sweep_ops
from neural_network_quantum_state_tpu_torch.ops.engine import Cache, Work
from neural_network_quantum_state_tpu_torch.ops.rng import make_generator
from neural_network_quantum_state_tpu_torch.sampler import chain_checkerboard, init_state, sweeps


def _np(c):
    return np.asarray(c.re) + 1j * np.asarray(c.im)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _pair(kind, n, dtype_j, dtype_t):
    if kind == "RBM":
        return JRBM(n_inputs=n, n_hiddens=12, dtype=dtype_j), RBM(n_inputs=n, n_hiddens=12, dtype=dtype_t)
    return JRBMTrSymm(n_inputs=n, alpha=2, dtype=dtype_j), RBMTrSymm(n_inputs=n, alpha=2, dtype=dtype_t)


def _params(jm, rng, scale):
    return {name: scale * (rng.normal(size=s) + 1j * rng.normal(size=s)) for name, s in jm.param_spec()}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("kind", ["RBM", "RBMTrSymm"])
def test_plain_sweep_matches_jax_decision_for_decision(kind, rng):
    n, k, n_sweeps = 8, 64, 3
    jm, tm = _pair(kind, n, jnp.float64, torch.float64)
    p_np = _params(jm, rng, 0.4)
    jp = {name: C(jnp.asarray(v.real), jnp.asarray(v.imag)) for name, v in p_np.items()}
    tp = params_from_jax(tm, p_np, device="cpu")
    spins = np.where(rng.random((k, n)) < 0.5, -1.0, 1.0)
    sched = chain_checkerboard(n)
    uniforms = rng.random((n_sweeps * n, k))

    jwork = jm.make_work(jp)
    jcache, jln = jengine.full_forward(jwork, jnp.asarray(spins))
    jc2, jl2, jacc = jmetropolis._sweep_scan(jwork, jcache, jln, jnp.asarray(np.tile(sched, n_sweeps)), jnp.asarray(uniforms))

    work = tm.make_work(tp)
    cache, ln = engine.full_forward(work, _t(spins))
    c2, l2, acc = sweep_ops.sweep_plain(work, cache, ln, _t(sched), _t(uniforms))

    np.testing.assert_array_equal(c2.spins.numpy(), np.asarray(jc2.spins))
    np.testing.assert_allclose(c2.y.numpy(), _np(jc2.y), rtol=0, atol=1e-10)
    np.testing.assert_allclose(c2.sa.numpy(), _np(jc2.sa), rtol=0, atol=1e-10)
    np.testing.assert_allclose(l2.numpy(), _np(jl2), rtol=0, atol=1e-10)
    assert float(acc) == float(jacc) > 0


def test_sweeps_sample_psi2(rng):
    """sweeps samples |psi|^2: chi^2 and total variation against exact
    enumeration at N=6."""
    n, k = 6, 1024
    jm, tm = _pair("RBM", n, jnp.float32, torch.float32)
    tp = params_from_jax(tm, _params(jm, rng, 0.25), device="cpu")
    work = tm.make_work(tp)
    g = make_generator(5, "cpu")
    spins = torch.where(torch.rand((k, n), generator=g) < 0.5, -1.0, 1.0)
    state = init_state(work, spins, g)
    sched = torch.as_tensor(chain_checkerboard(n))

    confs = np.array([[1.0 - 2.0 * ((i >> b) & 1) for b in range(n)] for i in range(2**n)])
    ln = engine.log_psi(tm.make_work(params_from_jax(RBM(n_inputs=n, n_hiddens=12, dtype=torch.float64),
                                                     {k_: v.numpy() for k_, v in tp.items()}, device="cpu")),
                        _t(confs))
    p = np.exp(2.0 * ln.real.numpy())
    p /= p.sum()

    state = sweeps(work, state, sched, 30)
    counts = np.zeros(2**n)
    bit_w = np.asarray([1 << b for b in range(n)])
    for _ in range(60):
        state = sweeps(work, state, sched, 2)
        idx = ((1.0 - state.cache.spins.numpy()) / 2.0 @ bit_w).astype(int)
        counts += np.bincount(idx, minlength=2**n)
    total = counts.sum()
    chi2 = float(np.sum((counts - total * p) ** 2 / (total * p)))
    tv = 0.5 * float(np.abs(counts / total - p).sum())
    assert chi2 / (2**n - 1) < 3.0, (chi2, tv)
    assert tv < 0.03, tv
    assert float(state.n_proposed) == 150 * n * k
    assert 0 < float(state.n_accepted) < float(state.n_proposed)
    assert p.max() > 4 * p.min()  # the target is far from uniform


def test_wrapper_runs_plain_on_cpu_and_kernel_refuses_cpu(rng):
    n, k = 8, 16
    tm = RBMTrSymm(n_inputs=n, alpha=4, dtype=torch.float32)
    work = tm.make_work(tm.init_params(make_generator(0, "cpu")))
    cache, ln = engine.full_forward(work, torch.ones((k, n)))
    u = torch.rand((n, k))
    sched = torch.as_tensor(chain_checkerboard(n))
    calls, launches = sweep_ops.sweep_plain.calls, sweep_ops.sweep_cuda.launches
    got = sweep_ops.metropolis_sweeps(work, cache, ln, sched, u)
    want = sweep_ops.sweep_plain(work, cache, ln, sched, u)
    np.testing.assert_array_equal(got[0].spins.numpy(), want[0].spins.numpy())
    assert sweep_ops.sweep_plain.calls == calls + 2
    with pytest.raises(ValueError, match="CUDA"):
        sweep_ops.sweep_cuda(work, cache, sched, u)
    assert sweep_ops.sweep_cuda.launches == launches


def test_sweeps_draw_one_block_of_uniforms_per_sweep():
    """n sweeps in one call are n wrapper calls, each on its own (N, K)
    block of uniforms drawn in turn from the state's generator."""
    n, k, n_sweeps = 8, 32, 3
    tm = RBMTrSymm(n_inputs=n, alpha=2, dtype=torch.float64)
    work = tm.make_work({name: 20.0 * v for name, v in tm.init_params(make_generator(0, "cpu")).items()})
    sched = torch.as_tensor(chain_checkerboard(n))
    spins = torch.where(torch.rand((k, n), generator=make_generator(1, "cpu")) < 0.5, -1.0, 1.0).double()
    state = init_state(work, spins, make_generator(2, "cpu"))
    calls = sweep_ops.sweep_plain.calls
    got = sweeps(work, state, sched, n_sweeps)
    assert sweep_ops.sweep_plain.calls == calls + n_sweeps
    assert sweeps(work, state, sched, 0) is not None and sweep_ops.sweep_plain.calls == calls + n_sweeps

    g = make_generator(2, "cpu")
    cache, ln, n_acc = state.cache, state.lnpsi, 0.0
    for _ in range(n_sweeps):
        cache, ln, acc = sweep_ops.sweep_plain(work, cache, ln, sched, torch.rand((n, k), generator=g, dtype=torch.float64))
        n_acc += float(acc)
    assert torch.equal(got.cache.spins, cache.spins) and torch.equal(got.lnpsi, ln)
    assert float(got.n_accepted) == n_acc and 0 < n_acc < n_sweeps * n * k
    assert float(got.n_proposed) == n_sweeps * n * k


def test_off_cpu_tensors_never_run_the_plain_sweep():
    """A tensor off the CPU goes to the kernel or raises: float64 is not
    ported (NotImplementedError); float32 reaches the kernel's input checks,
    which want a CUDA device (here the tensors are on the meta device)."""
    n, k = 8, 16
    sched = torch.as_tensor(chain_checkerboard(n))
    calls, launches = sweep_ops.sweep_plain.calls, sweep_ops.sweep_cuda.launches
    for dtype, err in ((torch.float64, NotImplementedError), (torch.float32, ValueError)):
        tm = RBMTrSymm(n_inputs=n, alpha=4, dtype=dtype)
        work = tm.make_work(tm.init_params(make_generator(0, "cpu")))
        cache, ln = engine.full_forward(work, torch.ones((k, n), dtype=dtype))
        meta_work = Work(*(t.to("meta") for t in work))
        meta_cache = Cache(*(t.to("meta") for t in cache))
        with pytest.raises(err):
            sweep_ops.metropolis_sweeps(meta_work, meta_cache, ln.to("meta"), sched, torch.rand((n, k), dtype=dtype).to("meta"))
    assert sweep_ops.sweep_plain.calls == calls and sweep_ops.sweep_cuda.launches == launches
