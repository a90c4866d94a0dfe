"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``gpu`` and skips where no CUDA device is
present. The file imports neither JAX nor the JAX package, so it also runs
on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:xdist -o addopts='' -q
"""

import numpy as np
import pytest
import torch

from neural_network_quantum_state_tpu_torch import VMC, VMCConfig
from neural_network_quantum_state_tpu_torch.hamiltonians import HubbardChain, LITFIChain
from neural_network_quantum_state_tpu_torch.models import RBM, RBMTrSymm
from neural_network_quantum_state_tpu_torch.ops import energy, engine
from neural_network_quantum_state_tpu_torch.ops import exchange as exchange_ops
from neural_network_quantum_state_tpu_torch.ops import sweep as sweep_ops
from neural_network_quantum_state_tpu_torch.ops.engine import Cache, Work
from neural_network_quantum_state_tpu_torch.ops.rng import make_generator
from neural_network_quantum_state_tpu_torch.sampler import chain_checkerboard


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run the gpu-marked tests on the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_sweep_kernel_matches_plain_on_card(cuda):
    """Kernel vs plain on the same uniforms: the same decisions except at
    rare near-ties, and the same y and ln psi where the decisions agree."""
    n, alpha, k = 16, 2, 512
    tm = RBMTrSymm(n_inputs=n, alpha=alpha, dtype=torch.float32)
    g = make_generator(1, cuda)
    params = {name: 5.0 * v for name, v in tm.init_params(g).items()}
    work = tm.make_work(params)
    cache, ln = engine.full_forward(work, torch.where(torch.rand((k, n), generator=g, device=cuda) < 0.5, -1.0, 1.0))
    sched = torch.as_tensor(chain_checkerboard(n))
    u = torch.rand((4 * n, k), generator=g, device=cuda)
    launches = sweep_ops.sweep_cuda.launches
    ck, lk, acc_k = sweep_ops.metropolis_sweeps(work, cache, ln, sched, u)
    cp, lp, acc_p = sweep_ops.sweep_plain(work, cache, ln, sched, u)
    assert sweep_ops.sweep_cuda.launches == launches + 1
    same = (ck.spins == cp.spins).all(dim=1)
    assert float(same.double().mean()) >= 1.0 - 1e-2
    torch.testing.assert_close(ck.y[same], cp.y[same], rtol=0, atol=1e-5)
    torch.testing.assert_close(lk[same], lp[same], rtol=0, atol=1e-4)
    fresh, _ = engine.full_forward(work, ck.spins)
    torch.testing.assert_close(ck.y, fresh.y, rtol=0, atol=2e-5)


@pytest.mark.gpu
def test_energy_kernel_matches_plain_on_card(cuda):
    n, alpha, k = 16, 2, 512
    tm = RBMTrSymm(n_inputs=n, alpha=alpha, dtype=torch.float32)
    g = make_generator(2, cuda)
    work = tm.make_work({name: 5.0 * v for name, v in tm.init_params(g).items()})
    cache, ln = engine.full_forward(work, torch.where(torch.rand((k, n), generator=g, device=cuda) < 0.5, -1.0, 1.0))
    launches = energy.offdiag_sum_cuda.launches
    got = energy.offdiag_sum(work, cache, ln)
    assert energy.offdiag_sum_cuda.launches == launches + 1
    want = energy.offdiag_sum_plain(work, cache, ln)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("use_fused_sweeps", [False, True])
def test_vmc_runs_through_both_kernels_on_card(cuda, use_fused_sweeps):
    """Whatever use_fused_sweeps says, the card runs both kernels: one
    sweep launch per sweep, one energy launch per step, no plain version."""
    n = 16
    vmc = VMC(
        RBMTrSymm(n_inputs=n, alpha=2, dtype=torch.float32),
        LITFIChain(n_sites=n, h=-0.5, j=0.866, alpha=2.5),
        VMCConfig(n_walkers=512, use_fused_sweeps=use_fused_sweeps, seed=2),
        device=cuda,
    )
    sweeps0, energy0 = sweep_ops.sweep_cuda.launches, energy.offdiag_sum_cuda.launches
    plain0 = sweep_ops.sweep_plain.calls + energy.offdiag_sum_plain.calls
    params, state = vmc.init()
    state = vmc.warm_up(params, state, 20)
    params, state, history, _ = vmc.run(params, state, 5)
    assert all(np.isfinite(r["energy"]) for r in history)
    assert sweep_ops.sweep_cuda.launches == sweeps0 + 20 + 5
    assert energy.offdiag_sum_cuda.launches == energy0 + 5
    assert sweep_ops.sweep_plain.calls + energy.offdiag_sum_plain.calls == plain0


def _sector_counts(spins, l):
    return (spins[:, :l] > 0).sum(1), (spins[:, l:] > 0).sum(1)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "per_flavor_rings, l, k",
    [(True, 8, 512), (False, 8, 512), (True, 20, 500)],
    ids=["two-rings", "one-ring", "two-rings-L20-K500"],
)
def test_exchange_kernel_matches_plain_on_card(cuda, per_flavor_rings, l, k):
    """Kernel vs plain on the same uniforms, H=32, at L=8 (N=16 = B) and at
    L=20 (B=40: a partial second word of the bond mask; K=500: a partial
    last block): the same decisions except at rare near-ties, the same y
    and ln psi where they agree, the particle sector kept, y consistent
    with the spins."""
    h, n_sweeps = 32, 4
    n = 2 * l
    tm = RBM(n_inputs=n, n_hiddens=h, dtype=torch.float32)
    g = make_generator(3, cuda)
    work = tm.make_work({name: 10.0 * v for name, v in tm.init_params(g).items()})
    ham = HubbardChain(n_sites=n, n_up=3, n_down=4, per_flavor_rings=per_flavor_rings)
    bonds = torch.as_tensor(ham.bonds, device=cuda)
    cache, ln = engine.full_forward(work, ham.init_spins(g, k))
    u_sel = torch.rand((n_sweeps * n, k), generator=g, device=cuda)
    u_acc = torch.rand((n_sweeps * n, k), generator=g, device=cuda)
    launches = exchange_ops.exchange_cuda.launches
    ck, lk, acc_k = exchange_ops.exchange_steps(work, cache, ln, bonds, u_sel, u_acc)
    cp, lp, acc_p = exchange_ops.exchange_plain(work, cache, ln, bonds, u_sel, u_acc)
    assert exchange_ops.exchange_cuda.launches == launches + 1
    same = (ck.spins == cp.spins).all(dim=1)
    assert float(same.double().mean()) >= 1.0 - 1e-2
    torch.testing.assert_close(ck.y[same], cp.y[same], rtol=0, atol=1e-5)
    torch.testing.assert_close(lk[same], lp[same], rtol=0, atol=1e-4)
    assert 0 < float(acc_k) < n_sweeps * n * k
    up, dn = _sector_counts(ck.spins, l)
    if per_flavor_rings:
        assert bool((up == 3).all()) and bool((dn == 4).all())
    else:
        assert bool((up + dn == 7).all())
    fresh, _ = engine.full_forward(work, ck.spins)
    torch.testing.assert_close(ck.y, fresh.y, rtol=0, atol=2e-5)


@pytest.mark.gpu
def test_hubbard_vmc_runs_through_the_exchange_kernel_on_card(cuda):
    """Hubbard training on the card: one exchange launch per sweep, no plain
    version and no single-flip sweep, the sector kept, finite energies."""
    l = 8
    vmc = VMC(
        RBM(n_inputs=2 * l, n_hiddens=32, dtype=torch.float32),
        HubbardChain(n_sites=2 * l, u=4.0, t=1.0, n_up=3, n_down=3),
        VMCConfig(n_walkers=512, use_fused_sweeps=True, seed=2),
        device=cuda,
    )
    ex0, sw0 = exchange_ops.exchange_cuda.launches, sweep_ops.sweep_cuda.launches
    plain0 = exchange_ops.exchange_plain.calls + sweep_ops.sweep_plain.calls
    params, state = vmc.init()
    state = vmc.warm_up(params, state, 20)
    params, state, history, _ = vmc.run(params, state, 5)
    assert all(np.isfinite(r["energy"]) for r in history)
    assert exchange_ops.exchange_cuda.launches == ex0 + 20 + 5
    assert sweep_ops.sweep_cuda.launches == sw0
    assert exchange_ops.exchange_plain.calls + sweep_ops.sweep_plain.calls == plain0
    up, dn = _sector_counts(state.cache.spins, l)
    assert bool((up == 3).all()) and bool((dn == 3).all())


def test_off_cpu_tensors_never_run_the_plain_exchange():
    """A tensor off the CPU goes to the kernel or raises: float64 is not
    ported (NotImplementedError); float32 reaches the kernel's checks, which
    refuse more bonds than sites and want a CUDA device (here the tensors
    are on the meta device). CPU tensors given to the kernel raise too."""
    l, k = 4, 16
    ham = HubbardChain(n_sites=2 * l, n_up=2, n_down=2)
    calls, launches = exchange_ops.exchange_plain.calls, exchange_ops.exchange_cuda.launches
    for dtype, err in ((torch.float64, NotImplementedError), (torch.float32, ValueError)):
        tm = RBM(n_inputs=2 * l, n_hiddens=32, dtype=dtype)
        work = tm.make_work(tm.init_params(make_generator(0, "cpu")))
        cache, ln = engine.full_forward(work, ham.init_spins(make_generator(1, "cpu"), k, dtype))
        u = torch.rand((2 * l, k), dtype=dtype)
        meta = lambda t: t.to("meta")  # noqa: E731
        with pytest.raises(err):
            exchange_ops.exchange_steps(
                Work(*map(meta, work)), Cache(*map(meta, cache)), meta(ln), meta(torch.as_tensor(ham.bonds)), meta(u), meta(u)
            )
    too_many = torch.as_tensor(np.concatenate([ham.bonds, ham.bonds]))
    with pytest.raises(ValueError, match="bond count"):
        exchange_ops.exchange_steps(Work(*map(meta, work)), Cache(*map(meta, cache)), meta(ln), meta(too_many), meta(u), meta(u))
    with pytest.raises(ValueError, match="CUDA"):
        exchange_ops.exchange_cuda(work, cache, torch.as_tensor(ham.bonds), u, u)
    assert exchange_ops.exchange_plain.calls == calls and exchange_ops.exchange_cuda.launches == launches


@pytest.mark.gpu
def test_exchange_kernel_refuses_what_it_does_not_take(cuda):
    """On the card: float64 is not ported, a hidden count outside the
    built set and more bonds than sites raise before any launch."""
    l, k = 4, 64
    ham = HubbardChain(n_sites=2 * l, n_up=2, n_down=2)
    bonds = torch.as_tensor(ham.bonds, device=cuda)
    launches = exchange_ops.exchange_cuda.launches
    for dtype, h, b, err in (
        (torch.float64, 32, bonds, NotImplementedError),
        (torch.float32, 48, bonds, ValueError),
        (torch.float32, 32, torch.cat([bonds, bonds]), ValueError),
    ):
        tm = RBM(n_inputs=2 * l, n_hiddens=h, dtype=dtype)
        g = make_generator(0, cuda)
        work = tm.make_work(tm.init_params(g))
        cache, ln = engine.full_forward(work, ham.init_spins(g, k, dtype))
        u = torch.rand((2 * l, k), generator=g, device=cuda, dtype=dtype)
        with pytest.raises(err):
            exchange_ops.exchange_steps(work, cache, ln, b, u, u)
    assert exchange_ops.exchange_cuda.launches == launches
