"""PyTorch port vs the JAX package: off-diagonal local energy and the Ising
local energies.

The plain off-diagonal sum is held to the JAX package's chunked path in
float64 (1e-10) and, in float32, to the JAX Pallas kernel run in interpret
mode, at that kernel's own bar of 3e-6 relative. The CUDA kernel's tests
are in test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_network_quantum_state_tpu.hamiltonians import LITFIChain as JLITFIChain
from neural_network_quantum_state_tpu.hamiltonians import TFIChain as JTFIChain
from neural_network_quantum_state_tpu.hamiltonians.ising import _offdiag_sum as j_offdiag_sum
from neural_network_quantum_state_tpu.models import RBM as JRBM
from neural_network_quantum_state_tpu.models import RBMTrSymm as JRBMTrSymm
from neural_network_quantum_state_tpu.ops import engine as jengine
from neural_network_quantum_state_tpu.ops.cplx import C
from neural_network_quantum_state_tpu.ops.pallas_energy import pallas_offdiag_sum
from neural_network_quantum_state_tpu_torch.hamiltonians import LITFIChain, TFIChain
from neural_network_quantum_state_tpu_torch.models import RBM, RBMTrSymm, params_from_jax
from neural_network_quantum_state_tpu_torch.ops import energy, engine
from neural_network_quantum_state_tpu_torch.ops.engine import Cache, Work
from neural_network_quantum_state_tpu_torch.ops.rng import make_generator


def _np(c):
    return np.asarray(c.re) + 1j * np.asarray(c.im)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _setup(kind, n, k, rng, f64=True, scale=0.4):
    """Same machine, parameters and spins in both packages."""
    dj, dt = (jnp.float64, torch.float64) if f64 else (jnp.float32, torch.float32)
    if kind == "RBM":
        jm, tm = JRBM(n_inputs=n, n_hiddens=12, dtype=dj), RBM(n_inputs=n, n_hiddens=12, dtype=dt)
    else:
        jm, tm = JRBMTrSymm(n_inputs=n, alpha=2, dtype=dj), RBMTrSymm(n_inputs=n, alpha=2, dtype=dt)
    if scale is None:  # the JAX machine's own initial parameters, as its kernel tests use
        p_np = {name: _np(v) for name, v in jm.init_params(jax.random.PRNGKey(0)).items()}
    else:
        p_np = {name: scale * (rng.normal(size=s) + 1j * rng.normal(size=s)) for name, s in jm.param_spec()}
    npdt = np.float64 if f64 else np.float32
    jp = {name: C(jnp.asarray(v.real, npdt), jnp.asarray(v.imag, npdt)) for name, v in p_np.items()}
    spins = np.where(rng.random((k, n)) < 0.5, -1.0, 1.0).astype(npdt)
    jwork = jm.make_work(jp)
    jcache, jln = jengine.full_forward(jwork, jnp.asarray(spins))
    work = tm.make_work(params_from_jax(tm, p_np, device="cpu"))
    cache, ln = engine.full_forward(work, _t(spins))
    return (jwork, jcache, jln), (work, cache, ln)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("kind", ["RBM", "RBMTrSymm"])
def test_plain_offdiag_matches_jax_f64(kind, rng):
    n = 16
    (jwork, jcache, jln), (work, cache, ln) = _setup(kind, n, 64, rng)
    want = _np(j_offdiag_sum(jwork, jcache, jln, n, fused=False))
    got = energy.offdiag_sum_plain(work, cache, ln).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("kind", ["RBM", "RBMTrSymm"])
def test_plain_offdiag_matches_pallas_interpret_f32(kind, rng):
    """float32 plain path vs the JAX Pallas energy kernel (interpret mode) on
    the inputs of the JAX package's own kernel test (initial parameters,
    random spins): max|difference| within 3e-6 of max|sum|, the kernel's bar
    against the XLA path."""
    n = 16
    (jwork, jcache, jln), (work, cache, ln) = _setup(kind, n, 128, rng, f64=False, scale=None)
    want = _np(pallas_offdiag_sum(jwork, jcache, jln, jnp.arange(n, dtype=jnp.int32), block_k=64, interpret=True))
    got = energy.offdiag_sum(work, cache, ln).numpy()
    assert got.dtype == np.complex64
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 3e-6, rel


def test_chunked_plain_path_matches_one_chunk(rng, monkeypatch):
    n = 16
    _, (work, cache, ln) = _setup("RBMTrSymm", n, 32, rng)
    whole = energy.offdiag_sum_plain(work, cache, ln)
    monkeypatch.setattr(energy, "OFFDIAG_CHUNK_ELEMS", 32 * work.w.shape[1] * 5)  # chunks of 5 sites
    np.testing.assert_allclose(energy.offdiag_sum_plain(work, cache, ln).numpy(), whole.numpy(), rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("ham", ["LITFIChain", "TFIChain"])
def test_local_energy_matches_jax(ham, rng):
    n = 16
    (jwork, jcache, jln), (work, cache, ln) = _setup("RBMTrSymm", n, 64, rng)
    if ham == "LITFIChain":
        jh, th = (cls(n_sites=n, h=-0.5, j=0.866, alpha=2.5, pbc=True) for cls in (JLITFIChain, LITFIChain))
    else:
        jh, th = (cls(n_sites=n, h=-1.0, j=-1.0) for cls in (JTFIChain, TFIChain))
    np.testing.assert_array_equal(th.schedule(), jh.schedule())
    want = _np(jh.local_energy(jwork, jcache, jln))
    np.testing.assert_allclose(th.local_energy(work, cache, ln).numpy(), want, rtol=1e-10, atol=1e-10)


def test_litfi_init_spins_and_j_matrix_match_jax():
    jh, th = JLITFIChain(n_sites=10, j=0.9), LITFIChain(n_sites=10, j=0.9)
    np.testing.assert_array_equal(th.j_matrix, jh.j_matrix)
    want = np.asarray(jh.init_spins(jax.random.PRNGKey(0), 4, jnp.float32))
    np.testing.assert_array_equal(th.init_spins(make_generator(0, "cpu"), 4).numpy(), want)
    with pytest.raises(ValueError, match="even L"):
        LITFIChain(n_sites=9)


def test_wrapper_runs_plain_on_cpu_and_kernel_refuses_cpu(rng):
    _, (work, cache, ln) = _setup("RBMTrSymm", 16, 32, rng, f64=False)
    calls, launches = energy.offdiag_sum_plain.calls, energy.offdiag_sum_cuda.launches
    np.testing.assert_array_equal(energy.offdiag_sum(work, cache, ln).numpy(), energy.offdiag_sum_plain(work, cache, ln).numpy())
    assert energy.offdiag_sum_plain.calls == calls + 2
    with pytest.raises(ValueError, match="CUDA"):
        energy.offdiag_sum_cuda(work, cache)
    assert energy.offdiag_sum_cuda.launches == launches


def test_off_cpu_tensors_never_run_the_plain_sum(rng):
    """A tensor off the CPU goes to the kernel or raises: float64 is not
    ported (NotImplementedError); float32 reaches the kernel's input checks,
    which want a CUDA device (here the tensors are on the meta device)."""
    calls, launches = energy.offdiag_sum_plain.calls, energy.offdiag_sum_cuda.launches
    for f64, err in ((True, NotImplementedError), (False, ValueError)):
        _, (work, cache, ln) = _setup("RBMTrSymm", 16, 8, rng, f64=f64)
        meta_work = Work(*(t.to("meta") for t in work))
        with pytest.raises(err):
            energy.offdiag_sum(meta_work, Cache(*(t.to("meta") for t in cache)), ln.to("meta"))
    assert energy.offdiag_sum_plain.calls == calls and energy.offdiag_sum_cuda.launches == launches
