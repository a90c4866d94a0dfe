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
from neural_network_quantum_state_tpu_torch.hamiltonians import HubbardChain, LITFIChain, TFIChain, TFICheckerBoard, TFITRI
from neural_network_quantum_state_tpu_torch.models import FFNN, FFNNTrSymm, RBM, RBMSfSymm, RBMTrSymm, RBMZ2PrSymm
from neural_network_quantum_state_tpu_torch.ops import chain_rate as chain_ops
from neural_network_quantum_state_tpu_torch.ops import energy, engine
from neural_network_quantum_state_tpu_torch.ops import exchange as exchange_ops
from neural_network_quantum_state_tpu_torch.ops import sweep as sweep_ops
from neural_network_quantum_state_tpu_torch.ops import sweep_energy
from neural_network_quantum_state_tpu_torch.ops.engine import Cache, Work
from neural_network_quantum_state_tpu_torch.ops.logcosh import near_branch_cut
from neural_network_quantum_state_tpu_torch.ops.rng import ExchangeDraws, PhiloxDraws, make_generator, philox_key
from neural_network_quantum_state_tpu_torch.optim import SRStats
from neural_network_quantum_state_tpu_torch.sampler import chain_checkerboard, init_state, kawasaki, metropolis, tempering


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
    sweep launch per sampler call (the warm-up's 20 sweeps, each step's
    sweep), one energy launch per step, no plain version."""
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
    assert sweep_ops.sweep_cuda.launches == sweeps0 + 1 + 5
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
    ck, lk, counts_k = exchange_ops.exchange_steps(work, cache, ln, bonds, u_sel, u_acc)
    cp, lp, acc_p = exchange_ops.exchange_plain(work, cache, ln, bonds, u_sel, u_acc)
    assert exchange_ops.exchange_cuda.launches == launches + 1
    acc_k = counts_k[0].sum()
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
@pytest.mark.parametrize("has_c", [False, True])
@pytest.mark.parametrize(
    "per_flavor_rings, l, k",
    [(True, 8, 512), (False, 8, 512), (True, 20, 500)],
    ids=["two-rings", "one-ring", "two-rings-L20-K500"],
)
def test_exchange_kernel_matches_plain_on_philox_stream(cuda, per_flavor_rings, l, k, has_c):
    """The kernel drawing its own uniforms (4 sweeps in one launch) against
    the plain rounds on the same Philox stream, with and without output
    weights c: the same decisions but for near-ties (and near-cut walkers),
    y and ln psi where they agree, the sectors kept, y consistent with the
    spins."""
    h, n_sweeps = 32, 4
    n = 2 * l
    if has_c:
        work, _, _, g = _scaled_ffnn(cuda, n, h, 8, 30 + l)
    else:
        work, _, _, g = _scaled_rbm(cuda, n, h, 8, 30 + l, scale=10.0)
    ham = HubbardChain(n_sites=n, n_up=3, n_down=4, per_flavor_rings=per_flavor_rings)
    bonds = torch.as_tensor(ham.bonds, device=cuda)
    cache, ln = engine.full_forward(work, ham.init_spins(g, k))
    draws = ExchangeDraws(philox_key(g), n_sweeps * n)
    launches = exchange_ops.exchange_cuda.launches
    ck, lk, counts_k = exchange_ops.exchange_steps(work, cache, ln, bonds, draws)
    cp, lp, acc_p = exchange_ops.exchange_plain(work, cache, ln, bonds, draws)
    assert exchange_ops.exchange_cuda.launches == launches + 1
    acc_k = counts_k[0].sum()
    same = _agreeing(ck, cp, 1e-2)
    torch.testing.assert_close(ck.y[same], cp.y[same], rtol=0, atol=1e-5)
    torch.testing.assert_close(lk[same], lp[same], rtol=0, atol=1e-4)
    assert 0 < float(acc_k) < n_sweeps * n * k
    assert abs(float(acc_k - acc_p)) <= 1e-2 * n_sweeps * n * k
    up, dn = _sector_counts(ck.spins, l)
    if per_flavor_rings:
        assert bool((up == 3).all()) and bool((dn == 4).all())
    else:
        assert bool((up + dn == 7).all())
    fresh, _ = engine.full_forward(work, ck.spins)
    torch.testing.assert_close(ck.y, fresh.y, rtol=0, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("has_c", [False, True])
@pytest.mark.parametrize("h", [16, 80, 384])
def test_exchange_kernel_philox_at_any_width_and_both_w_branches(cuda, h, has_c):
    """At H = 16, 80 and 384 the kernel reads W from shared memory where its
    block's layout fits (H = 16, 80 at N = 32; with c the rotation's table)
    and through L1 where it does not (H = 384), at the lanes per walker it
    chooses: each against the plain rounds on the same stream."""
    n, k = 32, 256
    work, _, _, g = _scaled_ffnn(cuda, n, h, 8, 50 + h) if has_c else _scaled_rbm(cuda, n, h, 8, 50 + h)
    ham = HubbardChain(n_sites=n, n_up=3, n_down=3)
    bonds = torch.as_tensor(ham.bonds, device=cuda)
    cache, ln = engine.full_forward(work, ham.init_spins(g, k))
    assert exchange_ops.stages_w(n, h, bonds.shape[0], has_c) == (h < 384)
    draws = ExchangeDraws(philox_key(g), 2 * n)
    ck, lk, _ = exchange_ops.exchange_cuda(work, cache, bonds, draws)
    cp, lp, _ = exchange_ops.exchange_plain(work, cache, ln, bonds, draws)
    same = _agreeing(ck, cp, 2e-2)
    torch.testing.assert_close(ck.y[same], cp.y[same], rtol=0, atol=2e-5)
    torch.testing.assert_close(lk[same], lp[same], rtol=0, atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("has_c", [False, True])
def test_exchange_kernel_chooses_lanes_and_w_branch_at_the_flagship_width(cuda, has_c):
    """The kernel's own choices: 8 lanes per walker up to H = 64, 16 up to
    128, else 32; W staged at the Hubbard flagship's N = 64, H = 64 (with c
    too); there, against the plain rounds on one stream."""
    assert [exchange_ops.kernel_lanes(h) for h in (1, 64, 65, 128, 129, 512)] == [8, 8, 16, 16, 32, 32]
    n, h, k = 64, 64, 512
    work, _, _, g = _scaled_ffnn(cuda, n, h, 8, 64) if has_c else _scaled_rbm(cuda, n, h, 8, 64, scale=10.0)
    ham = HubbardChain(n_sites=n, n_up=5, n_down=5)
    bonds = torch.as_tensor(ham.bonds, device=cuda)
    assert exchange_ops.stages_w(n, h, bonds.shape[0], has_c)
    cache, ln = engine.full_forward(work, ham.init_spins(g, k))
    draws = ExchangeDraws(philox_key(g), 2 * n)
    ck, lk, _ = exchange_ops.exchange_cuda(work, cache, bonds, draws)
    cp, lp, _ = exchange_ops.exchange_plain(work, cache, ln, bonds, draws)
    same = _agreeing(ck, cp, 1e-2)
    torch.testing.assert_close(ck.y[same], cp.y[same], rtol=0, atol=2e-5)
    torch.testing.assert_close(lk[same], lp[same], rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_exchange_kernel_keeps_words_past_its_registers(cuda):
    """A ring of 300 sites (B = N = 300: spin and mask words past the four
    in registers live in shared memory) against the plain rounds, on the
    stream and on caller uniforms."""
    n, h, k = 300, 16, 96
    work, _, _, g = _scaled_rbm(cuda, n, h, 8, 300)
    bonds = torch.as_tensor(kawasaki.ring_bonds(n), device=cuda)
    cache, ln = engine.full_forward(work, torch.where(torch.rand((k, n), generator=g, device=cuda) < 0.5, -1.0, 1.0))
    u_sel, u_acc = torch.rand((n, k), generator=g, device=cuda), torch.rand((n, k), generator=g, device=cuda)
    for args in ((ExchangeDraws(philox_key(g), 2 * n),), (u_sel, u_acc)):
        ck, lk, counts = exchange_ops.exchange_cuda(work, cache, bonds, *args)
        cp, lp, _ = exchange_ops.exchange_plain(work, cache, ln, bonds, *args)
        same = (ck.spins == cp.spins).all(dim=1)
        assert float(same.double().mean()) >= 1.0 - 3e-2
        torch.testing.assert_close(lk[same], lp[same], rtol=0, atol=2e-4)
        assert bool(((ck.spins > 0).sum(1) == (cache.spins > 0).sum(1)).all()) and float(counts[0].sum()) > 0


@pytest.mark.gpu
def test_exchange_sweeps_make_one_launch_per_call_on_card(cuda):
    """kawasaki.exchange_sweeps on the card: one launch for all the sweeps
    of a call, no uniform block drawn (one key), the plain rounds' decisions
    on the same stream, the proposals counted."""
    l, k, n_sweeps = 8, 256, 7
    ham = HubbardChain(n_sites=2 * l, n_up=3, n_down=3)
    work, _, _, g = _scaled_rbm(cuda, 2 * l, 32, 8, 77, scale=10.0)
    bonds = torch.as_tensor(ham.bonds, dtype=torch.int32, device=cuda)
    state = init_state(work, ham.init_spins(g, k), make_generator(78, cuda))
    key = philox_key(make_generator(78, cuda))  # the key the call draws
    launches, plain = exchange_ops.exchange_cuda.launches, exchange_ops.exchange_plain.calls
    got = kawasaki.exchange_sweeps(work, state, bonds, n_sweeps, ham.n_unit_steps)
    assert exchange_ops.exchange_cuda.launches == launches + 1 and exchange_ops.exchange_plain.calls == plain
    assert float(got.n_proposed) == n_sweeps * ham.n_unit_steps * k
    cp, lp, acc_p = exchange_ops.exchange_plain(work, state.cache, state.lnpsi, bonds,
                                                ExchangeDraws(key, n_sweeps * ham.n_unit_steps))
    same = (got.cache.spins == cp.spins).all(dim=1)
    assert float(same.double().mean()) >= 1.0 - 2e-2
    torch.testing.assert_close(got.lnpsi[same], lp[same], rtol=0, atol=1e-4)
    assert abs(float(got.n_accepted) - float(acc_p)) <= 2e-2 * n_sweeps * ham.n_unit_steps * k


@pytest.mark.gpu
def test_hubbard_vmc_runs_through_the_exchange_kernel_on_card(cuda):
    """Hubbard training on the card: one exchange launch per sampler call
    (the warm-up's 20 sweeps, each step's sweep), no plain version and no
    single-flip sweep, the sector kept, finite energies."""
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
    assert exchange_ops.exchange_cuda.launches == ex0 + 1 + 5
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
        meta = lambda t: None if t is None else t.to("meta")  # noqa: E731
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
    """On the card: float64 is not ported, a hidden count above the
    kernels' 512 and more bonds than sites raise before any launch; so do
    output weights c of the wrong shape or dtype (in every kernel's input
    checks), and any c in the megakernel (the RBM family only, as JAX)."""
    l, k = 4, 64
    ham = HubbardChain(n_sites=2 * l, n_up=2, n_down=2)
    bonds = torch.as_tensor(ham.bonds, device=cuda)
    launches = exchange_ops.exchange_cuda.launches
    for dtype, h, b, err in (
        (torch.float64, 32, bonds, NotImplementedError),
        (torch.float32, 513, bonds, ValueError),
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

    fm = FFNN(n_inputs=2 * l, n_hiddens=32, dtype=torch.float32)
    fwork = fm.make_work(fm.init_params(g))
    fcache, fln = engine.full_forward(fwork, ham.init_spins(g, k))
    sched = torch.as_tensor(chain_checkerboard(2 * l))
    u = torch.rand((2 * l, k), generator=g, device=cuda)
    counts = (sweep_ops.sweep_cuda.launches, energy.offdiag_sum_cuda.launches, exchange_ops.exchange_cuda.launches,
              sweep_energy.sweeps_offdiag_cuda.launches)
    for bad in (fwork.c[:-1], fwork.c.to(torch.complex128)):
        bad_work = fwork._replace(c=bad)
        for call in (lambda: sweep_ops.sweep_cuda(bad_work, fcache, sched, u),
                     lambda: energy.offdiag_sum_cuda(bad_work, fcache),
                     lambda: exchange_ops.exchange_cuda(bad_work, fcache, bonds, u, u)):
            with pytest.raises(ValueError, match="c must be"):
                call()
    with pytest.raises(ValueError, match="RBM family"):
        sweep_energy.sweeps_offdiag(fwork, fcache, fln, sched, u)
    assert counts == (sweep_ops.sweep_cuda.launches, energy.offdiag_sum_cuda.launches,
                      exchange_ops.exchange_cuda.launches, sweep_energy.sweeps_offdiag_cuda.launches)


def _scaled_rbm(cuda, n, h, k, seed, scale=5.0):
    """An RBM of width h with weights scaled so that |y| ~ 0.5, random
    spins, and its cache on the card."""
    tm = RBM(n_inputs=n, n_hiddens=h, dtype=torch.float32)
    g = make_generator(seed, cuda)
    work = tm.make_work({name: scale * v for name, v in tm.init_params(g).items()})
    cache, ln = engine.full_forward(work, torch.where(torch.rand((k, n), generator=g, device=cuda) < 0.5, -1.0, 1.0))
    return work, cache, ln, g


@pytest.mark.gpu
@pytest.mark.parametrize("n_beta, kb", [(2, 61), (6, 41), (16, 20)])
def test_tempered_sweep_kernel_matches_plain_on_card(cuda, n_beta, kb):
    """In-kernel replica exchange vs the plain tempered sweep on the same
    flip and swap uniforms, three sweeps, H=48 (a masked tail), blocks of
    whole replica groups (n_beta=2: a partial last block of idle warps):
    the same decisions except at rare near-ties, y and ln psi equal where
    they agree, the same swaps, y consistent with the spins."""
    n, h, n_sweeps = 16, 48, 3
    k = n_beta * kb
    work, cache, ln, g = _scaled_rbm(cuda, n, h, k, 7 + n_beta)
    sched = torch.as_tensor(chain_checkerboard(n))
    u = torch.rand((n_sweeps * n, k), generator=g, device=cuda)
    us = torch.rand((n_sweeps, 2, k), generator=g, device=cuda)
    launches = sweep_ops.sweep_cuda.launches
    ck, lk, rows_k = sweep_ops.metropolis_sweeps(work, cache, ln, sched, u, n_beta, us, rows=True)
    cp, lp, rows_p = sweep_ops.sweep_plain(work, cache, ln, sched, u, n_beta, us, rows=True)
    assert sweep_ops.sweep_cuda.launches == launches + 1
    same = (ck.spins == cp.spins).all(dim=1)
    assert float(same.double().mean()) >= 1.0 - 1e-2
    torch.testing.assert_close(ck.y[same], cp.y[same], rtol=0, atol=1e-5)
    torch.testing.assert_close(lk[same], lp[same], rtol=0, atol=1e-4)
    if bool(same.all()):
        assert torch.equal(rows_k, rows_p)
    assert 0 < float(rows_k[1].sum()) < n_sweeps * kb * (n_beta - 1)
    fresh, _ = engine.full_forward(work, ck.spins)
    torch.testing.assert_close(ck.y, fresh.y, rtol=0, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("n_beta", [1, 8])
def test_megakernel_matches_two_kernels_and_plain_on_card(cuda, n_beta):
    """The megakernel on the uniforms of the sweep kernel + energy kernel
    takes the same decisions (it runs their arithmetic) and forms the same
    sums; against the plain version, the same decisions but at near-ties
    and sums within 1e-5 relative where they agree."""
    n, h, k = 32, 64, 8 * 64
    work, cache, ln, g = _scaled_rbm(cuda, n, h, k, 21)
    sched = torch.as_tensor(chain_checkerboard(n))
    u = torch.rand((2 * n, k), generator=g, device=cuda)
    us = torch.rand((2, 2, k), generator=g, device=cuda) if n_beta > 1 else None
    launches = sweep_energy.sweeps_offdiag_cuda.launches
    cm, lm, am, om = sweep_energy.sweeps_offdiag(work, cache, ln, sched, u, n_beta, us)
    assert sweep_energy.sweeps_offdiag_cuda.launches == launches + 1
    c2, l2, a2 = sweep_ops.sweep_cuda(work, cache, sched, u, n_beta, us)
    o2 = energy.offdiag_sum_cuda(work, c2)
    assert torch.equal(cm.spins, c2.spins) and float(am) == float(a2)
    torch.testing.assert_close(cm.y, c2.y, rtol=0, atol=1e-6)
    assert float((om - o2).abs().max() / o2.abs().max()) < 1e-6
    cp, lp, ap, op = sweep_energy.sweeps_offdiag_plain(work, cache, ln, sched, u, n_beta, us)
    same = (cm.spins == cp.spins).all(dim=1)
    assert float(same.double().mean()) >= 1.0 - 1e-2
    assert float((om[same] - op[same]).abs().max() / op[same].abs().max()) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("h", [16, 80, 384])
def test_kernels_match_plain_at_any_hidden_width(cuda, h):
    """Every kernel at a width that is not a multiple of 32 or above 256:
    sweep (n_beta = 1 and 4), energy, megakernel and exchange against their
    plain versions on the same inputs."""
    n, k = 16, 256
    work, cache, ln, g = _scaled_rbm(cuda, n, h, k, h)
    sched = torch.as_tensor(chain_checkerboard(n))
    u = torch.rand((2 * n, k), generator=g, device=cuda)
    us = torch.rand((2, 2, k), generator=g, device=cuda)
    for nb in (1, 4):
        ck, lk, _ = sweep_ops.sweep_cuda(work, cache, sched, u, nb, us if nb > 1 else None)
        cp, lp, _ = sweep_ops.sweep_plain(work, cache, ln, sched, u, nb, us if nb > 1 else None)
        same = (ck.spins == cp.spins).all(dim=1)
        assert float(same.double().mean()) >= 1.0 - 2e-2, (h, nb)
        torch.testing.assert_close(ck.y[same], cp.y[same], rtol=0, atol=2e-5)
        torch.testing.assert_close(lk[same], lp[same], rtol=0, atol=2e-4)
    got, want = energy.offdiag_sum_cuda(work, cache), energy.offdiag_sum_plain(work, cache, ln)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5
    cm, _, _, om = sweep_energy.sweeps_offdiag_cuda(work, cache, sched, u)
    cp, _, _, op = sweep_energy.sweeps_offdiag_plain(work, cache, ln, sched, u)
    same = (cm.spins == cp.spins).all(dim=1)
    assert float(same.double().mean()) >= 1.0 - 2e-2
    assert float((om[same] - op[same]).abs().max() / op[same].abs().max()) < 1e-5

    ham = HubbardChain(n_sites=n, n_up=3, n_down=3)
    bonds = torch.as_tensor(ham.bonds, device=cuda)
    hcache, hln = engine.full_forward(work, ham.init_spins(g, k))
    u_sel, u_acc = torch.rand((2 * n, k), generator=g, device=cuda), torch.rand((2 * n, k), generator=g, device=cuda)
    xk, xlk, _ = exchange_ops.exchange_cuda(work, hcache, bonds, u_sel, u_acc)
    xp, xlp, _ = exchange_ops.exchange_plain(work, hcache, hln, bonds, u_sel, u_acc)
    same = (xk.spins == xp.spins).all(dim=1)
    assert float(same.double().mean()) >= 1.0 - 2e-2
    torch.testing.assert_close(xk.y[same], xp.y[same], rtol=0, atol=2e-5)
    torch.testing.assert_close(xlk[same], xlp[same], rtol=0, atol=2e-4)


@pytest.mark.gpu
def test_tempered_vmc_runs_through_the_kernels_on_card(cuda):
    """Tempered training on the card at the e2e oracle's H=16 (TFI, N=8):
    one sweep launch per sampler call (the swap phases inside it), one
    energy launch per step on the beta = 1 replicas, no plain version."""
    n, nb = 8, 4
    vmc = VMC(
        RBM(n_inputs=n, n_hiddens=16, dtype=torch.float32),
        TFIChain(n_sites=n, h=-1.0, j=-1.0),
        VMCConfig(n_walkers=512, learning_rate=1e-2, n_beta=nb, seed=17),
        device=cuda,
    )
    sweeps0, energy0 = sweep_ops.sweep_cuda.launches, energy.offdiag_sum_cuda.launches
    plain0 = sweep_ops.sweep_plain.calls + energy.offdiag_sum_plain.calls
    params, state = vmc.init()
    state = vmc.warm_up(params, state, 30)
    params, state, history, _ = vmc.run(params, state, 20)
    assert len(history) == 20 and all(np.isfinite(r["energy"]) for r in history)
    assert sweep_ops.sweep_cuda.launches == sweeps0 + 1 + 20
    assert energy.offdiag_sum_cuda.launches == energy0 + 20
    assert sweep_ops.sweep_plain.calls + energy.offdiag_sum_plain.calls == plain0
    assert all(0.0 < r["acceptance"] < 1.0 for r in history)
    fresh, _ = engine.full_forward(vmc.machine.make_work(params), state.cache.spins)
    torch.testing.assert_close(state.cache.y, fresh.y)


def _scaled_ffnn(cuda, n, h, k, seed, scale=1.5):
    """A plain FFNN of width h (every output weight c_j differs, so a wrong
    index into c shows), its imaginary planes raised to the size of the
    real ones (the init keeps them at 0.1 of it), then all scaled by
    `scale`: |y| ~ 0.3 to 1.1 in both planes from H = 384 to H = 16;
    random spins and the cache on the card."""
    tm = FFNN(n_inputs=n, n_hiddens=h, dtype=torch.float32)
    g = make_generator(seed, cuda)
    work = tm.make_work({name: scale * torch.complex(v.real, 10.0 * v.imag) for name, v in tm.init_params(g).items()})
    cache, ln = engine.full_forward(work, torch.where(torch.rand((k, n), generator=g, device=cuda) < 0.5, -1.0, 1.0))
    return work, cache, ln, g


def _agreeing(ck, cp, budget):
    """Walkers with the same decisions and no hidden unit near the branch
    cut in either final state; asserts that the others (near-ties and
    near-cut walkers) stay within `budget` of the walkers."""
    same = (ck.spins == cp.spins).all(dim=1) & ~near_branch_cut(ck.y) & ~near_branch_cut(cp.y)
    assert float(same.double().mean()) >= 1.0 - budget
    return same


@pytest.mark.gpu
@pytest.mark.parametrize("h", [16, 80, 256, 384])
def test_has_c_kernels_match_plain_on_card(cuda, h):
    """The instances with output weights c (plain FFNN) against their plain
    versions on the same inputs: the sweep at n_beta = 1 and 8, the energy
    and the exchange; near-cut walkers count with the near-ties."""
    n, k = 16, 512
    work, cache, ln, g = _scaled_ffnn(cuda, n, h, k, 40 + h)
    sched = torch.as_tensor(chain_checkerboard(n))
    u = torch.rand((2 * n, k), generator=g, device=cuda)
    us = torch.rand((2, 2, k), generator=g, device=cuda)
    launches = sweep_ops.sweep_cuda.launches
    for nb in (1, 8):
        ck, lk, _ = sweep_ops.metropolis_sweeps(work, cache, ln, sched, u, nb, us if nb > 1 else None)
        cp, lp, _ = sweep_ops.sweep_plain(work, cache, ln, sched, u, nb, us if nb > 1 else None)
        same = _agreeing(ck, cp, 2e-2)
        torch.testing.assert_close(ck.y[same], cp.y[same], rtol=0, atol=2e-5)
        torch.testing.assert_close(lk[same], lp[same], rtol=0, atol=2e-4)
        fresh, _ = engine.full_forward(work, ck.spins)
        torch.testing.assert_close(ck.y, fresh.y, rtol=0, atol=2e-5)
    assert sweep_ops.sweep_cuda.launches == launches + 2
    near = energy.offdiag_near_cut(work, cache)
    assert float(near.double().mean()) <= 2e-2
    got, want = energy.offdiag_sum(work, cache, ln), energy.offdiag_sum_plain(work, cache, ln)
    assert float((got[~near] - want[~near]).abs().max() / want[~near].abs().max()) < 1e-5

    ham = HubbardChain(n_sites=n, n_up=3, n_down=3)
    bonds = torch.as_tensor(ham.bonds, device=cuda)
    hcache, hln = engine.full_forward(work, ham.init_spins(g, k))
    u_sel, u_acc = torch.rand((2 * n, k), generator=g, device=cuda), torch.rand((2 * n, k), generator=g, device=cuda)
    xk, xlk, counts = exchange_ops.exchange_steps(work, hcache, hln, bonds, u_sel, u_acc)
    xp, xlp, _ = exchange_ops.exchange_plain(work, hcache, hln, bonds, u_sel, u_acc)
    same = _agreeing(xk, xp, 2e-2)
    torch.testing.assert_close(xk.y[same], xp.y[same], rtol=0, atol=2e-5)
    torch.testing.assert_close(xlk[same], xlp[same], rtol=0, atol=2e-4)
    assert 0 < float(counts[0].sum()) < 2 * n * k and not counts[1].any()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["RBMSfSymm", "RBMZ2PrSymm"])
def test_bias_free_rbms_run_the_kernels_on_card(cuda, kind):
    """Machines without a visible bias (the kernels read zeros for a):
    RBMSfSymm (H = 32) and RBMZ2PrSymm (H = 8: one word, 24 tail lanes)
    through the sweep, energy and exchange kernels against their plain
    versions."""
    n, k = 16, 256
    tm = RBMSfSymm(n_inputs=n, alpha=2) if kind == "RBMSfSymm" else RBMZ2PrSymm(n_inputs=n, alpha=2)
    g = make_generator(5, cuda)
    work = tm.make_work({name: 5.0 * v for name, v in tm.init_params(g).items()})
    assert work.a is None and work.c is None
    cache, ln = engine.full_forward(work, torch.where(torch.rand((k, n), generator=g, device=cuda) < 0.5, -1.0, 1.0))
    sched = torch.as_tensor(chain_checkerboard(n))
    u = torch.rand((2 * n, k), generator=g, device=cuda)
    ck, lk, _ = sweep_ops.sweep_cuda(work, cache, sched, u)
    cp, lp, _ = sweep_ops.sweep_plain(work, cache, ln, sched, u)
    same = _agreeing(ck, cp, 2e-2)
    torch.testing.assert_close(ck.y[same], cp.y[same], rtol=0, atol=2e-5)
    torch.testing.assert_close(lk[same], lp[same], rtol=0, atol=2e-4)
    got, want = energy.offdiag_sum_cuda(work, cache), energy.offdiag_sum_plain(work, cache, ln)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5
    ham = HubbardChain(n_sites=n, n_up=3, n_down=3)
    hcache, hln = engine.full_forward(work, ham.init_spins(g, k))
    bonds = torch.as_tensor(ham.bonds, device=cuda)
    xk, xlk, _ = exchange_ops.exchange_cuda(work, hcache, bonds, u, u.flip(0))
    xp, xlp, _ = exchange_ops.exchange_plain(work, hcache, hln, bonds, u, u.flip(0))
    same = _agreeing(xk, xp, 2e-2)
    torch.testing.assert_close(xlk[same], xlp[same], rtol=0, atol=2e-4)


@pytest.mark.gpu
def test_ffnn_vmc_runs_through_the_kernels_on_card(cuda):
    """FFNNTrSymm training on the card: one sweep launch (its instance with
    c) per sampler call, one energy launch per step, no plain version,
    finite energies, y consistent with the spins."""
    n = 16
    vmc = VMC(
        FFNNTrSymm(n_inputs=n, alpha=2, dtype=torch.float32),
        LITFIChain(n_sites=n, h=-0.5, j=0.866, alpha=2.5),
        VMCConfig(n_walkers=512, learning_rate=1e-2, seed=6),
        device=cuda,
    )
    sweeps0, energy0 = sweep_ops.sweep_cuda.launches, energy.offdiag_sum_cuda.launches
    plain0 = sweep_ops.sweep_plain.calls + energy.offdiag_sum_plain.calls
    params, state = vmc.init()
    state = vmc.warm_up(params, state, 20)
    params, state, history, _ = vmc.run(params, state, 5)
    assert len(history) == 5 and all(np.isfinite(r["energy"]) for r in history)
    assert sweep_ops.sweep_cuda.launches == sweeps0 + 1 + 5
    assert energy.offdiag_sum_cuda.launches == energy0 + 5
    assert sweep_ops.sweep_plain.calls + energy.offdiag_sum_plain.calls == plain0
    fresh, _ = engine.full_forward(vmc.machine.make_work(params), state.cache.spins)
    torch.testing.assert_close(state.cache.y, fresh.y, rtol=0, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("has_c", [False, True])
@pytest.mark.parametrize("n_beta", [1, 8])
@pytest.mark.parametrize("h", [16, 80, 256, 384])
def test_redesigned_kernels_match_plain_on_uniforms_and_philox(cuda, h, n_beta, has_c):
    """The sweep kernel's instance (with or without c, n_beta = 1 or the
    tempered one) against the plain sweep on the same caller uniforms and on
    the same Philox stream (the kernel drawing its own), and the energy
    kernel's instance against the plain sum: the same decisions but for
    near-ties and near-cut walkers, y and ln psi where they agree."""
    n, k = 16, 512
    if has_c:
        work, cache, ln, g = _scaled_ffnn(cuda, n, h, k, 70 + h)
    else:
        tm = RBM(n_inputs=n, n_hiddens=h)
        g = make_generator(70 + h, cuda)
        work = tm.make_work({name: 10.0 * v for name, v in tm.init_params(g).items()})
        cache, ln = engine.full_forward(work, torch.where(torch.rand((k, n), generator=g, device=cuda) < 0.5, -1.0, 1.0))
    sched = torch.as_tensor(chain_checkerboard(n))
    u = torch.rand((2 * n, k), generator=g, device=cuda)
    us = torch.rand((2, 2, k), generator=g, device=cuda) if n_beta > 1 else None
    draws = PhiloxDraws(philox_key(g), 2 * n)
    launches = sweep_ops.sweep_cuda.launches
    for uniforms, swaps in ((u, us), (draws, None)):
        ck, lk, rows_k = sweep_ops.sweep_cuda(work, cache, sched, uniforms, n_beta, swaps, rows=True)
        cp, lp, rows_p = sweep_ops.sweep_plain(work, cache, ln, sched, uniforms, n_beta, swaps, rows=True)
        same = _agreeing(ck, cp, 2e-2)
        torch.testing.assert_close(ck.y[same], cp.y[same], rtol=0, atol=2e-5)
        torch.testing.assert_close(lk[same], lp[same], rtol=0, atol=2e-4)
        assert 0 < float(rows_k[0].sum()) < 2 * n * k
        assert abs(float(rows_k[0].sum() - rows_p[0].sum())) <= 2e-2 * 2 * n * k
    assert sweep_ops.sweep_cuda.launches == launches + 2
    near = energy.offdiag_near_cut(work, cache) if has_c else torch.zeros(k, dtype=torch.bool, device=cuda)
    got, want = energy.offdiag_sum_cuda(work, cache), energy.offdiag_sum_plain(work, cache, ln)
    assert float((got[~near] - want[~near]).abs().max() / want[~near].abs().max()) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("n_beta", [1, 8])
def test_sweeps_make_one_launch_per_sampler_call_on_card(cuda, n_beta):
    """metropolis.sweeps and tempering.tempering_sweeps run a whole call (5
    sweeps, with the swap phases for n_beta > 1) as one launch on one
    Philox key, count every proposal, and leave y consistent."""
    n, k = 16, 512
    work, cache, ln = _scaled_rbm(cuda, n, 32, k, 81)[:3]
    state = init_state(work, cache.spins, make_generator(4, cuda))
    sched = torch.as_tensor(chain_checkerboard(n), device=cuda)
    launches, plain = sweep_ops.sweep_cuda.launches, sweep_ops.sweep_plain.calls
    if n_beta == 1:
        out = metropolis.sweeps(work, state, sched, 5)
    else:
        out = tempering.tempering_sweeps(work, state, sched, 5, n_beta)
    assert sweep_ops.sweep_cuda.launches == launches + 1 and sweep_ops.sweep_plain.calls == plain
    assert float(out.n_proposed) == 5 * n * k and 0 < float(out.n_accepted) < 5 * n * k
    fresh, lnpsi = engine.full_forward(work, out.cache.spins)
    torch.testing.assert_close(out.cache.y, fresh.y, rtol=0, atol=1e-4)
    torch.testing.assert_close(out.lnpsi, lnpsi, rtol=0, atol=1e-3)
    none = metropolis.sweeps(work, state, sched, 0)
    assert torch.equal(none.cache.spins, state.cache.spins) and float(none.n_proposed) == 0.0
    assert sweep_ops.sweep_cuda.launches == launches + 1  # no sweep: no launch


@pytest.mark.gpu
@pytest.mark.parametrize("has_c", [False, True])
@pytest.mark.parametrize("n_beta", [1, 8])
def test_five_sweeps_in_one_launch_match_plain_on_one_philox_stream(cuda, n_beta, has_c):
    """5 sweeps in one launch against the plain sweep on the same Philox
    stream: the same decisions but for near-ties and near-cut walkers."""
    n, h, k = 16, 48, 512
    if has_c:
        work, cache, ln, g = _scaled_ffnn(cuda, n, h, k, 91)
    else:
        work, cache, ln, g = _scaled_rbm(cuda, n, h, k, 91)
    sched = torch.as_tensor(chain_checkerboard(n))
    draws = PhiloxDraws(philox_key(g), 5 * n)
    ck, lk, rows_k = sweep_ops.sweep_cuda(work, cache, sched, draws, n_beta, rows=True)
    cp, lp, rows_p = sweep_ops.sweep_plain(work, cache, ln, sched, draws, n_beta, rows=True)
    same = _agreeing(ck, cp, 2e-2)
    torch.testing.assert_close(ck.y[same], cp.y[same], rtol=0, atol=2e-5)
    torch.testing.assert_close(lk[same], lp[same], rtol=0, atol=2e-4)
    assert abs(float(rows_k[0].sum() - rows_p[0].sum())) <= 2e-2 * 5 * n * k


@pytest.mark.gpu
@pytest.mark.parametrize("lattice", ["checkerboard", "triangular"])
def test_sweep_kernel_on_2d_schedules_matches_plain(cuda, lattice):
    """The sweep kernel takes any schedule: the 8x8 square checkerboard and
    the 9x9 three-colour one, against the plain sweep on one stream."""
    ham = TFICheckerBoard(n_sites=64) if lattice == "checkerboard" else TFITRI(n_sites=81)
    work, cache, ln, g = _scaled_rbm(cuda, ham.n_sites, 64, 512, 93)
    sched = torch.as_tensor(ham.schedule())
    draws = PhiloxDraws(philox_key(g), 2 * ham.n_sites)
    ck, lk, _ = sweep_ops.sweep_cuda(work, cache, sched, draws)
    cp, lp, _ = sweep_ops.sweep_plain(work, cache, ln, sched, draws)
    same = _agreeing(ck, cp, 1e-2)
    torch.testing.assert_close(lk[same], lp[same], rtol=0, atol=2e-4)


def _widened(work, cache):
    w64 = Work(*(None if t is None else t.to(torch.complex128) for t in work))
    return (w64, *engine.full_forward(w64, cache.spins.double()))


@pytest.mark.gpu
@pytest.mark.parametrize("has_c", [False, True])
@pytest.mark.parametrize("h", [16, 80, 384])
def test_float64_energy_instance_matches_plain(cuda, h, has_c):
    """The energy kernel's float64 instance against the plain float64 sum:
    1e-12 relative; it counts in launches_f64 (with c also in
    launches_f64_c), not in launches."""
    n, k = 16, 512
    maker = _scaled_ffnn if has_c else _scaled_rbm
    work, cache, ln = maker(cuda, n, h, k, 100 + h)[:3]
    w64, c64, l64 = _widened(work, cache)
    fn = energy.offdiag_sum_cuda
    counts = (fn.launches, fn.launches_f64, fn.launches_f64_c)
    got = energy.offdiag_sum(w64, c64, l64)
    assert (fn.launches, fn.launches_f64, fn.launches_f64_c) == (counts[0], counts[1] + 1, counts[2] + int(has_c))
    want = energy.offdiag_sum_plain(w64, c64, l64)
    assert got.dtype == torch.complex128
    assert float((got - want).abs().max() / want.abs().max()) < 1e-12


@pytest.mark.gpu
def test_energy_wrapper_refuses_other_dtypes(cuda):
    work, cache = _scaled_rbm(cuda, 16, 32, 64, 5)[:2]
    launches = (energy.offdiag_sum_cuda.launches, energy.offdiag_sum_cuda.launches_f64)
    with pytest.raises(NotImplementedError, match="float32 and float64"):
        energy.offdiag_sum_cuda(work, cache._replace(spins=cache.spins.half()))
    w64 = Work(*(None if t is None else t.to(torch.complex128) for t in work))
    with pytest.raises(ValueError, match="must be"):  # float32 spins with float64 weights
        energy.offdiag_sum_cuda(w64, cache)
    assert (energy.offdiag_sum_cuda.launches, energy.offdiag_sum_cuda.launches_f64) == launches


@pytest.mark.gpu
@pytest.mark.parametrize(
    "change",
    [
        {"solver": "lu"}, {"solver": "cholesky"}, {"solver": "svd"}, {"solver": "minsr"}, {"solver": "sgd"},
        {"solver": "minresqlp"}, {"solver": "auto"}, {"solver": "cholesky", "n_accumulations": 3},
        {"precond_ema": 0.9}, {"energy_dtype": torch.float64}, {"energy_dtype": "compensated"},
        {"block_moves_per_sweep": 1}, {"solver": "auto", "cg_max_iters": 2},
    ],
    ids=["lu", "cholesky", "svd", "minsr", "sgd", "minresqlp", "auto", "accumulated", "precond_ema",
         "energy_float64", "compensated", "block_moves", "auto_fallback"],
)
def test_vmc_solvers_and_modes_run_through_the_kernels_on_card(cuda, change):
    """Each solver and precision mode on the card: one sweep launch per
    sampler call, the energy kernel's float32 instance once per sampling
    round (its float64 instance for energy_dtype=float64, none for the
    compensated sum), no plain version, finite energies."""
    n, steps = 16, 4
    rounds = change.get("n_accumulations", 1)
    vmc = VMC(RBMTrSymm(n_inputs=n, alpha=2, dtype=torch.float32), LITFIChain(n_sites=n, h=-0.5, j=0.866, alpha=2.5),
              VMCConfig(n_walkers=512, learning_rate=1e-2, seed=8, **change), device=cuda)
    counts0 = (sweep_ops.sweep_cuda.launches, energy.offdiag_sum_cuda.launches, energy.offdiag_sum_cuda.launches_f64)
    plain0 = sweep_ops.sweep_plain.calls + energy.offdiag_sum_plain.calls
    params, state = vmc.init()
    state = vmc.warm_up(params, state, 20)
    params, state, history, _ = vmc.run(params, state, steps)
    assert len(history) == steps and all(np.isfinite(r["energy"]) for r in history)
    e32 = 0 if "energy_dtype" in change else steps * rounds
    e64 = steps if change.get("energy_dtype") == torch.float64 else 0
    assert (sweep_ops.sweep_cuda.launches - counts0[0], energy.offdiag_sum_cuda.launches - counts0[1],
            energy.offdiag_sum_cuda.launches_f64 - counts0[2]) == (1 + steps * rounds, e32, e64)
    assert sweep_ops.sweep_plain.calls + energy.offdiag_sum_plain.calls == plain0
    if "cg_max_iters" in change:  # CG capped at 2 iterations, unconverged: auto falls back to MINRES-QLP
        assert vmc.n_qlp_fallbacks > 0


@pytest.mark.gpu
@pytest.mark.parametrize("has_c", [False, True])
@pytest.mark.parametrize("n_beta", [4, 8])
@pytest.mark.parametrize("h", [16, 80, 384])
def test_tempered_exchange_kernel_matches_plain_on_card(cuda, h, n_beta, has_c):
    """The exchange kernel's tempered instance (one launch: sweeps of N
    proposals at the rows' betas, each followed by its two swap phases)
    against the plain tempered exchange, at H = 16, 80 (W or the rotation's
    table in shared memory) and 384 (through L1): two sweeps on the Philox
    stream and one on caller uniforms, the same decisions but for near-ties
    (and near-cut walkers), y and ln psi where they agree, the per-row
    counts, every replica in its sector, y consistent with the spins."""
    n, k = 32, 384
    work, _, _, g = _scaled_ffnn(cuda, n, h, 8, 90 + h) if has_c else _scaled_rbm(cuda, n, h, 8, 90 + h)
    ham = HubbardChain(n_sites=n, n_up=3, n_down=4)
    bonds = torch.as_tensor(ham.bonds, device=cuda)
    cache, ln = engine.full_forward(work, ham.init_spins(g, k))
    n_unit = ham.n_unit_steps
    draws = ExchangeDraws(philox_key(g), 2 * n_unit)
    uniforms = (torch.rand((n_unit, k), generator=g, device=cuda), torch.rand((n_unit, k), generator=g, device=cuda))
    swaps = torch.rand((1, 2, k), generator=g, device=cuda)
    for args, sw, n_sweeps in (((draws, None), None, 2), (uniforms, swaps, 1)):
        kw = {"n_beta": n_beta, "n_unit": n_unit, "swap_uniforms": sw}
        fn = exchange_ops.exchange_cuda
        launches = (fn.launches, fn.launches_tempered, fn.launches_tempered_c)
        ck, lk, rows_k = exchange_ops.exchange_steps(work, cache, ln, bonds, *args, **kw)
        assert (fn.launches, fn.launches_tempered, fn.launches_tempered_c) == (
            launches[0] + 1, launches[1] + 1, launches[2] + int(has_c))
        cp, lp, rows_p = exchange_ops.tempered_exchange_plain(work, cache, ln, bonds, *args, **kw)
        same = _agreeing(ck, cp, 2e-2)
        torch.testing.assert_close(ck.y[same], cp.y[same], rtol=0, atol=2e-5)
        torch.testing.assert_close(lk[same], lp[same], rtol=0, atol=2e-4)
        if bool((ck.spins == cp.spins).all()):
            assert torch.equal(rows_k, rows_p)
        assert 0 < float(rows_k[1].sum()) < n_sweeps * (k // n_beta) * (n_beta - 1)
        up, dn = _sector_counts(ck.spins, n // 2)
        assert bool((up == 3).all()) and bool((dn == 4).all())
        fresh, _ = engine.full_forward(work, ck.spins)
        torch.testing.assert_close(ck.y, fresh.y, rtol=0, atol=2e-5)
    assert exchange_ops.stages_w(n, h, bonds.shape[0], has_c, n_beta) == (h < 384)


@pytest.mark.gpu
def test_tempered_exchange_sweeps_make_one_launch_per_call_on_card(cuda):
    """kawasaki.tempered_exchange_sweeps on the card: one launch of the
    tempered instance for all the sweeps of a call on one key, the plain
    tempered exchange's decisions on the same stream, the proposals counted;
    a ladder above the kernel's 16 replicas is refused before any launch."""
    l, k, n_sweeps, n_beta = 8, 256, 7, 4
    ham = HubbardChain(n_sites=2 * l, n_up=3, n_down=3)
    work, _, _, g = _scaled_rbm(cuda, 2 * l, 32, 8, 78, scale=10.0)
    bonds = torch.as_tensor(ham.bonds, dtype=torch.int32, device=cuda)
    state = init_state(work, ham.init_spins(g, k), make_generator(79, cuda))
    key = philox_key(make_generator(79, cuda))  # the key the call draws
    launches, plain = exchange_ops.exchange_cuda.launches_tempered, exchange_ops.exchange_plain.calls
    got = kawasaki.tempered_exchange_sweeps(work, state, bonds, n_sweeps, ham.n_unit_steps, n_beta)
    assert exchange_ops.exchange_cuda.launches_tempered == launches + 1 and exchange_ops.exchange_plain.calls == plain
    assert float(got.n_proposed) == n_sweeps * ham.n_unit_steps * k
    cp, lp, acc_p = exchange_ops.tempered_exchange_plain(
        work, state.cache, state.lnpsi, bonds, ExchangeDraws(key, n_sweeps * ham.n_unit_steps), None, n_beta,
        ham.n_unit_steps)
    same = (got.cache.spins == cp.spins).all(dim=1)
    assert float(same.double().mean()) >= 1.0 - 2e-2
    torch.testing.assert_close(got.lnpsi[same], lp[same], rtol=0, atol=1e-4)
    assert abs(float(got.n_accepted) - float(acc_p[0].sum())) <= 2e-2 * n_sweeps * ham.n_unit_steps * k
    with pytest.raises(ValueError, match="ladder"):
        kawasaki.tempered_exchange_sweeps(work, init_state(work, ham.init_spins(g, 32 * 8), g), bonds, 1,
                                          ham.n_unit_steps, 32)
    assert exchange_ops.exchange_cuda.launches_tempered == launches + 1


@pytest.mark.gpu
def test_collapsed_hubbard_run_escalates_on_card(cuda):
    """A collapsed Hubbard run on the card (the SR step stubbed to report
    rsd 0) escalates to tempered exchange with n_beta = 4 and finishes its
    steps through the tempered instance, one launch per step, every replica
    in its sector, finite energies."""
    l, k = 4, 256
    vmc = VMC(RBM(n_inputs=2 * l, n_hiddens=16, dtype=torch.float32), HubbardChain(n_sites=2 * l, n_up=2, n_down=1),
              VMCConfig(n_walkers=k, seed=1, collapse_patience=2, collapse_requil_sweeps=0), device=cuda)
    assert vmc._can_escalate()
    vmc.step = lambda params, state, step_idx: (
        params, state, SRStats(energy=torch.tensor(-1.0 + 0j), rsd=torch.tensor(0.0), cg_iters=0, lam=1.0))
    params, state = vmc.init()
    launches, plain = exchange_ops.exchange_cuda.launches_tempered, exchange_ops.exchange_plain.calls
    _, state, history, _ = vmc.run(params, state, 5)
    assert vmc.n_remediations == 1 and [h["step"] for h in history] == [0, 1, 2, 3, 4]
    assert exchange_ops.exchange_cuda.launches_tempered == launches + 3  # the three tempered steps
    assert exchange_ops.exchange_plain.calls == plain
    up, dn = _sector_counts(state.cache.spins, l)
    assert bool((up == 2).all()) and bool((dn == 1).all())
    assert all(np.isfinite(h["energy"]) for h in history)


@pytest.mark.gpu
@pytest.mark.parametrize("body", ["sweep", "energy"])
def test_chain_kernel_matches_plain_on_card(cuda, body):
    """The chain-rate probe's kernel against its plain chain on bench.py's
    inputs (2^18 elements, 32 bodies): max|kernel - plain| over both
    outputs within 1e-5 of their largest |value|, away from the energy
    body's branch cut (whose share stays under 1e-2); one launch counted."""
    x, y = chain_ops.probe_inputs(1 << 18, cuda)
    launches = chain_ops.chain_cuda.launches
    kx, ky = chain_ops.chain_cuda(body, x, y)
    assert chain_ops.chain_cuda.launches == launches + 1
    px, py = chain_ops.chain_plain(body, x, y)
    far = ~chain_ops.chain_near_cut(body, x, y)
    got, want = torch.stack([kx, ky]), torch.stack([px, py])
    assert bool(torch.isfinite(got).all())
    assert float((got - want)[:, far].abs().max() / want.abs().max()) <= 1e-5
    assert float(far.double().mean()) >= 1.0 - 1e-2
    assert chain_ops.chain_rate(body, n_elems=1 << 18, device=cuda) > 0.0

