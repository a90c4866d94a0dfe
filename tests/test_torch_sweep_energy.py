"""PyTorch port vs the JAX package: the fused sweep + energy megakernel's
plain version, its dispatch, and the kernel build's bookkeeping.

The plain megakernel (plain sweep, then the plain off-diagonal sum on the
same uniforms) is held to the JAX package's XLA composition -
``metropolis._sweep_scan`` (or the tempered scan with its swap phases) then
``ising._offdiag_sum(..., fused=False)`` - at float64, 1e-10. The CUDA
kernel's tests are in test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_network_quantum_state_tpu.hamiltonians import ising as jising
from neural_network_quantum_state_tpu.models import RBM as JRBM
from neural_network_quantum_state_tpu.models import RBMTrSymm as JRBMTrSymm
from neural_network_quantum_state_tpu.ops import engine as jengine
from neural_network_quantum_state_tpu.ops.cplx import C
from neural_network_quantum_state_tpu.sampler import metropolis as jmetropolis
from neural_network_quantum_state_tpu.sampler import tempering as jtempering
from neural_network_quantum_state_tpu_torch import megakernel_ab
from neural_network_quantum_state_tpu_torch.models import RBM, RBMTrSymm, params_from_jax
from neural_network_quantum_state_tpu_torch.ops import build, engine
from neural_network_quantum_state_tpu_torch.ops import energy as energy_ops
from neural_network_quantum_state_tpu_torch.ops import sweep as sweep_ops
from neural_network_quantum_state_tpu_torch.ops import sweep_energy
from neural_network_quantum_state_tpu_torch.ops.engine import Cache, Work
from neural_network_quantum_state_tpu_torch.ops.rng import make_generator
from neural_network_quantum_state_tpu_torch.sampler import chain_checkerboard


def _np(c):
    return np.asarray(c.re) + 1j * np.asarray(c.im)


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("n_beta", [1, 4])
@pytest.mark.parametrize("kind", ["RBM", "RBMTrSymm"])
def test_plain_megakernel_matches_jax_composition(kind, n_beta, rng):
    """Two sweeps then the off-diagonal sum of every row's post-sweep state:
    the same spins and acceptance, y, ln psi and the sum within 1e-10."""
    n, kb, n_sweeps = 12, 16, 2
    k = kb * n_beta
    if kind == "RBM":
        jm, tm = JRBM(n_inputs=n, n_hiddens=9, dtype=jnp.float64), RBM(n_inputs=n, n_hiddens=9, dtype=torch.float64)
    else:
        jm, tm = JRBMTrSymm(n_inputs=n, alpha=2, dtype=jnp.float64), RBMTrSymm(n_inputs=n, alpha=2, dtype=torch.float64)
    p_np = {name: 0.3 * (rng.normal(size=s) + 1j * rng.normal(size=s)) for name, s in jm.param_spec()}
    jp = {name: C(jnp.asarray(v.real), jnp.asarray(v.imag)) for name, v in p_np.items()}
    spins = np.where(rng.random((k, n)) < 0.5, -1.0, 1.0)
    sched = chain_checkerboard(n)
    u_flip = rng.random((n_sweeps * n, k))
    u_swap = rng.random((n_sweeps, 2, k))

    jwork = jm.make_work(jp)
    jcache, jln = jengine.full_forward(jwork, jnp.asarray(spins))
    if n_beta == 1:
        jcache, jln, jacc = jmetropolis._sweep_scan(jwork, jcache, jln, jnp.asarray(np.tile(sched, n_sweeps)), jnp.asarray(u_flip))
        jacc = float(jacc)
    else:
        beta = jtempering.replica_betas(n_beta, kb, jnp.float64)
        jacc = 0.0
        for s in range(n_sweeps):
            jcache, jln, n_acc = jtempering._tempered_flip_scan(
                jwork, jcache, jln, jnp.asarray(sched), jnp.asarray(u_flip[s * n:(s + 1) * n]), beta
            )
            jacc += float(np.sum(n_acc))
            for parity in (0, 1):
                jcache, jln, _ = jtempering._swap_phase(jcache, jln, jnp.asarray(u_swap[s, parity]), parity, n_beta, kb)
    joff = jising._offdiag_sum(jwork, jcache, jln, n, fused=False)

    work = tm.make_work(params_from_jax(tm, p_np, device="cpu"))
    cache, ln = engine.full_forward(work, _t(spins))
    calls = sweep_energy.sweeps_offdiag_plain.calls
    c2, l2, acc, off = sweep_energy.sweeps_offdiag(
        work, cache, ln, _t(sched), _t(u_flip), n_beta, _t(u_swap) if n_beta > 1 else None
    )
    assert sweep_energy.sweeps_offdiag_plain.calls == calls + 1

    np.testing.assert_array_equal(c2.spins.numpy(), np.asarray(jcache.spins))
    assert float(acc) == jacc > 0
    np.testing.assert_allclose(c2.y.numpy(), _np(jcache.y), rtol=0, atol=1e-10)
    np.testing.assert_allclose(l2.numpy(), _np(jln), rtol=0, atol=1e-10)
    np.testing.assert_allclose(off.numpy(), _np(joff), rtol=1e-10, atol=1e-10)


def test_megakernel_plain_is_the_sweep_then_the_sum():
    """The plain megakernel is the plain sweep followed by the plain sum on
    the same uniforms, bit for bit (the comparison the card makes)."""
    n, k, nb = 8, 32, 4
    tm = RBMTrSymm(n_inputs=n, alpha=2, dtype=torch.float32)
    work = tm.make_work({name: 10.0 * v for name, v in tm.init_params(make_generator(0, "cpu")).items()})
    g = make_generator(1, "cpu")
    cache, ln = engine.full_forward(work, torch.where(torch.rand((k, n), generator=g) < 0.5, -1.0, 1.0))
    sched = torch.as_tensor(chain_checkerboard(n))
    u, us = torch.rand((2 * n, k), generator=g), torch.rand((2, 2, k), generator=g)
    c1, l1, a1, off = sweep_energy.sweeps_offdiag_plain(work, cache, ln, sched, u, nb, us)
    c2, l2, a2 = sweep_ops.sweep_plain(work, cache, ln, sched, u, nb, us)
    assert torch.equal(c1.spins, c2.spins) and torch.equal(c1.y, c2.y) and torch.equal(l1, l2) and float(a1) == float(a2)
    assert torch.equal(off, energy_ops.offdiag_sum_plain(work, c2, l2))


def test_off_cpu_tensors_never_run_the_plain_megakernel():
    """A tensor off the CPU goes to the kernel or raises: float64 is not
    ported (NotImplementedError); float32 reaches the kernel's input checks,
    which want a CUDA device (meta tensors here), and a ladder over the
    kernel's 16 rungs is refused. CPU tensors given to the kernel raise."""
    n, k = 8, 32
    sched = torch.as_tensor(chain_checkerboard(n))
    calls, launches = sweep_energy.sweeps_offdiag_plain.calls, sweep_energy.sweeps_offdiag_cuda.launches
    meta = lambda t: None if t is None else t.to("meta")  # noqa: E731
    for dtype, nb, err in ((torch.float64, 1, NotImplementedError), (torch.float32, 1, ValueError),
                           (torch.float32, 4, ValueError), (torch.float32, 32, ValueError)):
        tm = RBMTrSymm(n_inputs=n, alpha=2, dtype=dtype)
        work = tm.make_work(tm.init_params(make_generator(0, "cpu")))
        cache, ln = engine.full_forward(work, torch.ones((k, n), dtype=dtype))
        u, us = torch.rand((n, k), dtype=dtype), torch.rand((1, 2, k), dtype=dtype)
        with pytest.raises(err):
            sweep_energy.sweeps_offdiag(Work(*map(meta, work)), Cache(*map(meta, cache)), meta(ln), sched, meta(u), nb, meta(us))
    with pytest.raises(ValueError, match="CUDA"):
        sweep_energy.sweeps_offdiag_cuda(work, cache, sched, u, 4, us)
    assert sweep_energy.sweeps_offdiag_plain.calls == calls
    assert sweep_energy.sweeps_offdiag_cuda.launches == launches


def test_kernel_checks_take_every_hidden_width_to_512():
    """The kernels take 1 <= H <= 512 (R = ceil(H/32) words, tail masked):
    H=16, 80 and 384 reach the device check; H=513 names the limit."""
    def check(h):
        t = torch.empty((4, h), dtype=torch.complex64, device="meta")
        build.check_inputs("sweep", torch.device("cuda"), h, {"y": (t, torch.complex64, (4, h))})

    for h in (1, 16, 80, 384, 512):
        with pytest.raises(ValueError, match="must be a contiguous"):  # the meta device, not the width
            check(h)
    for h in (0, 513):
        with pytest.raises(ValueError, match=r"\[1, 512\]"):
            check(h)


def test_build_hash_covers_the_shared_header(tmp_path, monkeypatch):
    """A library's name hashes its source and every shared header: an
    edited csrc/*.cuh gives every kernel a new target, so a stale library
    is never loaded."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for p in build.CSRC_DIR.iterdir():
        (csrc / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    assert set(build.KERNELS) == {"sweep", "energy", "exchange", "sweep_energy", "chain_rate"}
    before = {name: build._target(name) for name in build.KERNELS}
    assert before == {name: build._target(name) for name in build.KERNELS}
    (csrc / "rbm.cuh").write_text((csrc / "rbm.cuh").read_text() + "\n// edited\n")
    after = {name: build._target(name) for name in build.KERNELS}
    assert all(before[name] != after[name] for name in build.KERNELS)


def test_megakernel_ab_needs_a_cuda_device(monkeypatch, capsys):
    """The A/B entry point refuses to run without a CUDA device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert megakernel_ab.main(["--n-beta", "1"]) == 1
    assert "CUDA" in capsys.readouterr().err
