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
from neural_network_quantum_state_tpu_torch.utils.f32_stress import F32_STRESS, f32_stress_inputs
from neural_network_quantum_state_tpu_torch.utils.f64_stress import F64_STRESS, f64_stress_inputs


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
    """A tensor off the CPU goes to the kernel or raises: float32 and
    float64 reach the kernel's checks, which refuse more bonds than sites
    and want a CUDA device (here the tensors are on the meta device); a
    dtype with no instance (float16 spins) is not ported
    (NotImplementedError). CPU tensors given to the kernel raise too."""
    l, k = 4, 16
    ham = HubbardChain(n_sites=2 * l, n_up=2, n_down=2)
    calls = exchange_ops.exchange_plain.calls
    launches = (exchange_ops.exchange_cuda.launches, exchange_ops.exchange_cuda.launches_f64)
    for dtype, half, err in ((torch.float32, True, NotImplementedError), (torch.float64, False, ValueError),
                             (torch.float32, False, ValueError)):
        tm = RBM(n_inputs=2 * l, n_hiddens=32, dtype=dtype)
        work = tm.make_work(tm.init_params(make_generator(0, "cpu")))
        cache, ln = engine.full_forward(work, ham.init_spins(make_generator(1, "cpu"), k, dtype))
        if half:
            cache = cache._replace(spins=cache.spins.half())
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
    assert exchange_ops.exchange_plain.calls == calls
    assert (exchange_ops.exchange_cuda.launches, exchange_ops.exchange_cuda.launches_f64) == launches


@pytest.mark.gpu
def test_exchange_kernel_refuses_what_it_does_not_take(cuda):
    """On the card: a dtype with no instance (float16 spins), a hidden
    count above the kernels' 512 (in float32 and float64) and more bonds
    than sites raise before any launch; so do output weights c of the wrong
    shape or dtype (in every kernel's input checks), and any c in the
    megakernel (the RBM family only, as JAX)."""
    l, k = 4, 64
    ham = HubbardChain(n_sites=2 * l, n_up=2, n_down=2)
    bonds = torch.as_tensor(ham.bonds, device=cuda)
    launches = (exchange_ops.exchange_cuda.launches, exchange_ops.exchange_cuda.launches_f64)
    for dtype, h, b, err in (
        (torch.float16, 32, bonds, NotImplementedError),
        (torch.float64, 513, bonds, ValueError),
        (torch.float32, 513, bonds, ValueError),
        (torch.float32, 32, torch.cat([bonds, bonds]), ValueError),
    ):
        tm = RBM(n_inputs=2 * l, n_hiddens=h, dtype=torch.float32 if dtype == torch.float16 else dtype)
        g = make_generator(0, cuda)
        work = tm.make_work(tm.init_params(g))
        cache, ln = engine.full_forward(work, ham.init_spins(g, k, tm.dtype))
        cache = cache._replace(spins=cache.spins.to(dtype))
        u = torch.rand((2 * l, k), generator=g, device=cuda, dtype=tm.dtype)
        with pytest.raises(err):
            exchange_ops.exchange_steps(work, cache, ln, b, u, u)
    assert (exchange_ops.exchange_cuda.launches, exchange_ops.exchange_cuda.launches_f64) == launches

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
    """The megakernel (the factor form) on the uniforms of the sweep kernel +
    energy kernel (the log-cosh form) and of the plain version: the same
    decisions but at near-ties, y equal where they agree (the same fused
    multiply-adds), the sums within 1e-5 relative there."""
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
    cp, lp, ap, op = sweep_energy.sweeps_offdiag_plain(work, cache, ln, sched, u, n_beta, us)
    for spins, y, off in ((c2.spins, c2.y, o2), (cp.spins, cp.y, op)):
        same = (cm.spins == spins).all(dim=1)
        assert float(same.double().mean()) >= 1.0 - 1e-2
        torch.testing.assert_close(cm.y[same], y[same], rtol=0, atol=1e-6)
        assert float((om[same] - off[same]).abs().max() / off[same].abs().max()) < 1e-5
    assert abs(float(am) - float(ap)) <= 1e-2 * k * 2 * n


@pytest.mark.gpu
@pytest.mark.parametrize("h", [48, 128, 160])
def test_megakernel_on_philox_draws_and_odd_walker_count_on_card(cuda, h):
    """The megakernel at n_beta = 1 on the Philox stream, K = 16 * 8 + 1
    walkers (at H <= 128 two walkers a warp: the last warp holds one walker
    past K; H = 160: one warp a walker), against the plain version on the
    same draws: the same decisions but at near-ties, y and the sums as in
    the other megakernel tests."""
    n, k = 32, 16 * 8 + 1
    work, cache, ln, g = _scaled_rbm(cuda, n, h, k, 40 + h)
    sched = torch.as_tensor(chain_checkerboard(n))
    draws = PhiloxDraws(philox_key(g), 3 * n)
    cm, _, am, om = sweep_energy.sweeps_offdiag_cuda(work, cache, sched, draws)
    cp, _, ap, op = sweep_energy.sweeps_offdiag_plain(work, cache, ln, sched, draws)
    same = (cm.spins == cp.spins).all(dim=1)
    assert float(same.double().mean()) >= 1.0 - 2e-2
    torch.testing.assert_close(cm.y[same], cp.y[same], rtol=0, atol=1e-6)
    assert float((om[same] - op[same]).abs().max() / op[same].abs().max()) < 1e-5
    assert 0 < float(am) and abs(float(am) - float(ap)) <= 2e-2 * k * 3 * n


def _stress_rbm(cuda, case, n, k, seed):
    """utils/f32_stress.py's inputs on the card (float32), and the same
    values widened to float64 with the float32 y as it is."""
    w, b, a, spins = f32_stress_inputs(case, seed=seed, n=n, k=k)
    work = Work(*(torch.as_tensor(x, dtype=torch.complex64, device=cuda) for x in (w, b, a)))
    cache, ln = engine.full_forward(work, torch.as_tensor(spins, dtype=torch.float32, device=cuda))
    w64 = Work(*(None if t is None else t.to(torch.complex128) for t in work))
    c64 = Cache(cache.spins.double(), cache.y.to(torch.complex128), cache.sa.to(torch.complex128))
    return work, cache, ln, w64, c64


@pytest.mark.gpu
@pytest.mark.parametrize("n_beta", [1, 4])
@pytest.mark.parametrize("case", F32_STRESS)
def test_megakernel_on_stress_inputs_on_card(cuda, case, n_beta):
    """The megakernel on utils/f32_stress.py's inputs (|Re w| = 20, a unit
    near a zero of cosh, large |Re y|; N = 16, K = 512, two sweeps): its
    decisions and y against the plain megakernel in float64 from the same
    state on the same uniforms (the plain float32 version's dln loses about
    3e-4 there), its sums against the plain float64 sum on its own final
    state, within 1e-5 of the largest |value|; finite."""
    n, k = 16, 512
    work, cache, _, w64, c64 = _stress_rbm(cuda, case, n, k, 7)
    g = make_generator(8, cuda)
    sched = torch.as_tensor(chain_checkerboard(n))
    u = torch.rand((2 * n, k), generator=g, device=cuda)
    us = torch.rand((2, 2, k), generator=g, device=cuda) if n_beta > 1 else None
    cm, _, am, om = sweep_energy.sweeps_offdiag_cuda(work, cache, sched, u, n_beta, us)
    cp, _, _, _ = sweep_energy.sweeps_offdiag_plain(w64, c64, engine.cache_log_psi(w64, c64), sched, u.double(),
                                                    n_beta, None if us is None else us.double())
    same = (cm.spins.double() == cp.spins).all(dim=1)
    assert float(same.double().mean()) >= 1.0 - 1e-2
    y_ref = cp.y[same]
    assert float((cm.y[same].to(torch.complex128) - y_ref).abs().max()) <= 1e-5 * float(cp.y.abs().max())
    f64 = Cache(cm.spins.double(), cm.y.to(torch.complex128), cm.sa.to(torch.complex128))
    want = energy.offdiag_sum_plain(w64, f64, engine.cache_log_psi(w64, f64))
    assert bool(torch.isfinite(om).all()) and float(am) > 0
    assert float((om.to(torch.complex128) - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.gpu
def test_megakernel_refuses_weights_past_its_range_on_card(cuda):
    """|Re w| = 20 (engine.F32_MAX_RE_W) runs; the same weights moved to
    20.5 raise ValueError with no launch."""
    n, k = 16, 64
    work, cache, _, _, _ = _stress_rbm(cuda, "Re w 20", n, k, 5)
    sched = torch.as_tensor(chain_checkerboard(n))
    u = torch.rand((n, k), generator=make_generator(6, cuda), device=cuda)
    sweep_energy.sweeps_offdiag_cuda(work, cache, sched, u)
    launches = sweep_energy.sweeps_offdiag_cuda.launches
    past = work._replace(w=work.w + (engine.F32_MAX_RE_W + 0.5 - 20.0) * (work.w.real == 20.0))
    with pytest.raises(ValueError, match="Re w"):
        sweep_energy.sweeps_offdiag_cuda(past, cache, sched, u)
    torch.cuda.synchronize()
    assert sweep_energy.sweeps_offdiag_cuda.launches == launches


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
@pytest.mark.parametrize("h", [16, 80, 200, 256, 384, 512])
def test_float64_energy_instance_matches_plain(cuda, h, has_c):
    """The energy kernel's float64 instance against the plain float64 sum:
    1e-12 relative over every walker, at widths from part of one tile of
    32 units to 16 tiles (partial last tiles at 16, 80 and 200, the
    flagship's 256, the widest 512); it counts in launches_f64 (with c also
    in launches_f64_c), not in launches."""
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
@pytest.mark.parametrize("has_c", [False, True], ids=["rbm", "with_c"])
@pytest.mark.parametrize("case", F64_STRESS)
@pytest.mark.parametrize("n", [16, 72])
def test_float64_energy_instance_on_stress_inputs(cuda, case, has_c, n):
    """The float64 instance on utils/f64_stress.py's inputs (large |Re w|, a
    product that leaves the double range without its running exponent, units
    near a zero of cosh), one pass of sites and two, against the plain
    float64 sum: 1e-12 relative; with c over the walkers away from the
    branch cut (offdiag_near_cut), at most 1% of them counted apart."""
    w, b, a, c, spins = f64_stress_inputs(case, has_c, seed=11, n=n, k=300)
    work = Work(*(None if x is None else torch.as_tensor(x, device=cuda) for x in (w, b, a, c)))
    cache, ln = engine.full_forward(work, torch.as_tensor(spins, device=cuda))
    got, want = energy.offdiag_sum_cuda(work, cache), energy.offdiag_sum_plain(work, cache, ln)
    far = ~energy.offdiag_near_cut(work, cache) if has_c else torch.ones_like(got, dtype=torch.bool)
    assert float(far.double().mean()) >= 0.99
    assert bool(torch.isfinite(got).all())
    assert float((got - want)[far].abs().max() / want[far].abs().max()) < 1e-12


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



def _f64_states_agree(ck, lk, cp, lp, max_share):
    """Float64 kernel vs plain states: the share of walkers with other
    decisions, or near the branch cut with c (float64's tolerance), at most
    max_share; on the others y within 1e-12 of its largest |value| and
    ln psi within 1e-10."""
    differ = (ck.spins != cp.spins).any(1) | near_branch_cut(ck.y) | near_branch_cut(cp.y)
    same = ~differ
    assert float(differ.double().mean()) <= max_share
    assert float((ck.y[same] - cp.y[same]).abs().max()) <= 1e-12 * float(cp.y.abs().max())
    assert float((lk[same] - lp[same]).abs().max()) <= 1e-10


def _f64_machine(cuda, n, h, k, has_c, seed):
    """RBM(n, h) scaled so that |y| ~ 0.5, or FFNN(n, h) with its imaginary
    planes scaled alike, in float64, with random spins on the card."""
    g = make_generator(seed, cuda)
    if has_c:
        m = FFNN(n_inputs=n, n_hiddens=h, dtype=torch.float64)
        params = {name: torch.complex(v.real, 10.0 * v.imag) for name, v in m.init_params(g).items()}
    else:
        m = RBM(n_inputs=n, n_hiddens=h, dtype=torch.float64)
        params = {name: 10.0 * v for name, v in m.init_params(g).items()}
    work = m.make_work(params)
    cache, ln = engine.full_forward(work, torch.where(torch.rand((k, n), generator=g, device=cuda) < 0.5, -1.0, 1.0)
                                    .double())
    return work, cache, ln, g


@pytest.mark.gpu
@pytest.mark.parametrize("n_beta", [1, 8])
@pytest.mark.parametrize("has_c", [False, True], ids=["rbm", "c"])
@pytest.mark.parametrize("h", [16, 80, 256, 512])
def test_float64_sweep_instance_matches_plain(cuda, h, has_c, n_beta):
    """The sweep kernel's float64 instances (csrc/sweep_f64.cu) against the
    plain float64 sweep: two sweeps on the Philox stream and one on float64
    caller uniforms, one launch each (counted in launches_f64, never in
    the float32 count), every H on one instance."""
    n, k = 32, 512
    work, cache, ln, g = _f64_machine(cuda, n, h, k, has_c, 3 + h)
    sched = torch.as_tensor(chain_checkerboard(n), device=cuda)
    u = torch.rand((n, k), generator=g, device=cuda, dtype=torch.float64)
    us = torch.rand((1, 2, k), generator=g, device=cuda, dtype=torch.float64) if n_beta > 1 else None
    for args in ((PhiloxDraws(philox_key(g), 2 * n), n_beta), (u, n_beta, us)):
        launches = (sweep_ops.sweep_cuda.launches, sweep_ops.sweep_cuda.launches_f64)
        ck, lk, acc = sweep_ops.sweep_cuda(work, cache, sched, *args)
        assert (sweep_ops.sweep_cuda.launches, sweep_ops.sweep_cuda.launches_f64) == (launches[0], launches[1] + 1)
        cp, lp, _ = sweep_ops.sweep_plain(work, cache, ln, sched, *args)
        _f64_states_agree(ck, lk, cp, lp, 1e-2)
        assert ck.y.dtype == torch.complex128 and float(acc) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("has_c", [False, True], ids=["rbm", "c"])
@pytest.mark.parametrize("case", F64_STRESS)
def test_float64_sweep_instance_on_stress_inputs(cuda, case, has_c):
    """The float64 sweep on utils/f64_stress.py's inputs (large |Re w|, a
    site whose unscaled product of cosh ratios leaves the double range,
    units near a zero of cosh; H up to 512): the sums of logs stay finite
    and the decisions are the plain version's."""
    w, b, a, c, spins = f64_stress_inputs(case, has_c, seed=5, n=16, k=300)
    work = Work(*(None if x is None else torch.as_tensor(x, device=cuda) for x in (w, b, a, c)))
    cache, ln = engine.full_forward(work, torch.as_tensor(spins, device=cuda))
    draws = PhiloxDraws(philox_key(make_generator(9, cuda)), 2 * 16)
    sched = torch.arange(16, dtype=torch.int32, device=cuda)
    ck, lk, _ = sweep_ops.sweep_cuda(work, cache, sched, draws)
    cp, lp, _ = sweep_ops.sweep_plain(work, cache, ln, sched, draws)
    assert bool(torch.isfinite(ck.y).all())
    _f64_states_agree(ck, lk, cp, lp, 1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("has_c", [False, True], ids=["rbm", "c"])
@pytest.mark.parametrize("n", [16, 72])
def test_float64_sweep_instance_at_re_w_25(cuda, n, has_c):
    """The float64 sweep on utils/f64_stress.py's "Re w 25" inputs (H = 128:
    a flip of site 0 takes each unit's factor to about e^{200}, four of them
    past the double range unless each pair is renormalised; without c the
    flip decided by the uniforms), two sweeps on the Philox stream, against
    the plain float64 sweep; the same weights moved past the kernel's range
    raise before any launch."""
    w, b, a, c, spins = f64_stress_inputs("Re w 25", has_c, seed=5, n=n, k=300)
    work = Work(*(None if x is None else torch.as_tensor(x, device=cuda) for x in (w, b, a, c)))
    cache, ln = engine.full_forward(work, torch.as_tensor(spins, device=cuda))
    draws = PhiloxDraws(philox_key(make_generator(9, cuda)), 2 * n)
    sched = torch.arange(n, dtype=torch.int32, device=cuda)
    ck, lk, _ = sweep_ops.sweep_cuda(work, cache, sched, draws)
    cp, lp, _ = sweep_ops.sweep_plain(work, cache, ln, sched, draws)
    assert bool(torch.isfinite(ck.y).all())
    _f64_states_agree(ck, lk, cp, lp, 1e-2)
    launches = sweep_ops.sweep_cuda.launches_f64
    past = work._replace(w=work.w + (engine.F64_MAX_RE_W + 1.0 - 25.0) * (work.w.real == 25.0))
    with pytest.raises(ValueError, match="Re w"):  # past the kernel's range: raises, launches nothing
        sweep_ops.sweep_cuda(past, cache, sched, draws)
    assert sweep_ops.sweep_cuda.launches_f64 == launches


@pytest.mark.gpu
@pytest.mark.parametrize("has_c", [False, True], ids=["rbm", "c"])
@pytest.mark.parametrize("h", [384, 512])
def test_float64_sweep_ladder_of_16_at_wide_h(cuda, h, has_c):
    """The largest ladder, n_beta = 16 (blocks of 16 warps, each with its
    walker's y and c_j in shared memory), at R = 12 and 16: two sweeps with
    their swap phases on the Philox stream against the plain tempered
    sweep, with the per-row counts of accepted flips and swaps."""
    n, k, n_beta = 32, 512, 16
    work, cache, ln, g = _f64_machine(cuda, n, h, k, has_c, 91 + h)
    sched = torch.as_tensor(chain_checkerboard(n), device=cuda)
    draws = PhiloxDraws(philox_key(g), 2 * n)
    ck, lk, rows_k = sweep_ops.sweep_cuda(work, cache, sched, draws, n_beta, rows=True)
    cp, lp, rows_p = sweep_ops.sweep_plain(work, cache, ln, sched, draws, n_beta, rows=True)
    _f64_states_agree(ck, lk, cp, lp, 1e-2)
    same = ~((ck.spins != cp.spins).any(1) | near_branch_cut(ck.y) | near_branch_cut(cp.y))
    chains = same.reshape(-1, n_beta).all(1).repeat_interleave(n_beta)
    assert torch.equal(rows_k[:, chains], rows_p[:, chains]) and float(rows_k[1].sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("has_c", [False, True], ids=["rbm", "c"])
def test_float64_sweep_100_sweeps_in_one_launch(cuda, has_c):
    """A warm-up's launch of 100 sweeps (n_steps = 100 N; the kernel renews
    its factor state at every start of the schedule, so its drift stays
    bounded by one sweep) against the plain float64 sweep on the same Philox
    draws, and the carried y against a fresh forward pass of the final
    spins."""
    n, h, k = 32, 256, 256
    work, cache, ln, g = _f64_machine(cuda, n, h, k, has_c, 71)
    sched = torch.as_tensor(chain_checkerboard(n), device=cuda)
    draws = PhiloxDraws(philox_key(g), 100 * n)
    launches = sweep_ops.sweep_cuda.launches_f64
    ck, lk, acc = sweep_ops.sweep_cuda(work, cache, sched, draws)
    assert sweep_ops.sweep_cuda.launches_f64 == launches + 1
    cp, lp, _ = sweep_ops.sweep_plain(work, cache, ln, sched, draws)
    _f64_states_agree(ck, lk, cp, lp, 1e-2)
    assert 0.0 < float(acc) < 100 * n * k
    fresh, _ = engine.full_forward(work, ck.spins)
    assert float((fresh.y - ck.y).abs().max()) <= 1e-10 * float(fresh.y.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("has_c", [False, True], ids=["rbm", "c"])
def test_float64_sweep_tempered_at_row0_with_n_beta_8(cuda, has_c):
    """The float64 sweep's tempered instances at n_beta = 8 (blocks of one
    ladder, H = 256: the R = 8 instance) on the Philox stream at row0 = K/2,
    a walker mesh's shard, against the plain tempered sweep on the same
    draws, with the per-row counts of accepted flips and swaps; another
    offset moves the decisions."""
    n, h, k, n_beta = 32, 256, 512, 8
    work, cache, ln, g = _f64_machine(cuda, n, h, k, has_c, 81)
    sched = torch.as_tensor(chain_checkerboard(n), device=cuda)
    draws = PhiloxDraws(philox_key(g), 2 * n, row0=k // 2)
    ck, lk, rows_k = sweep_ops.sweep_cuda(work, cache, sched, draws, n_beta, rows=True)
    cp, lp, rows_p = sweep_ops.sweep_plain(work, cache, ln, sched, draws, n_beta, rows=True)
    _f64_states_agree(ck, lk, cp, lp, 1e-2)
    same = ~((ck.spins != cp.spins).any(1) | near_branch_cut(ck.y) | near_branch_cut(cp.y))
    chains = same.reshape(-1, n_beta).all(1).repeat_interleave(n_beta)  # swaps couple the rows of a chain
    assert torch.equal(rows_k[:, chains], rows_p[:, chains]) and float(rows_k[1].sum()) > 0
    other = sweep_ops.sweep_cuda(work, cache, sched, draws._replace(row0=0), n_beta)[0]
    assert not torch.equal(other.spins, ck.spins)


@pytest.mark.gpu
@pytest.mark.parametrize("n_beta", [1, 4])
@pytest.mark.parametrize("has_c", [False, True], ids=["rbm", "c"])
@pytest.mark.parametrize("h", [16, 64, 80, 384])
def test_float64_exchange_instance_matches_plain(cuda, h, has_c, n_beta):
    """The exchange kernel's float64 instances (csrc/exchange_f64.cu)
    against the plain float64 (tempered) exchange at L=32 (N=64 = B): two
    sweeps on the Philox stream and one on float64 caller uniforms, one
    launch each (counted in launches_f64, the tempered ones in
    launches_f64_tempered), every walker row in its sector."""
    l, k = 32, 512
    work, _, _, g = _f64_machine(cuda, 2 * l, h, k, has_c, 7 + h)
    ham = HubbardChain(n_sites=2 * l, n_up=5, n_down=5)
    cache, ln = engine.full_forward(work, ham.init_spins(g, k, torch.float64))
    bonds = torch.as_tensor(ham.bonds, device=cuda)
    u_sel, u_acc = (torch.rand((2 * l, k), generator=g, device=cuda, dtype=torch.float64) for _ in range(2))
    swaps = torch.rand((1, 2, k), generator=g, device=cuda, dtype=torch.float64) if n_beta > 1 else None
    for args in ((ExchangeDraws(philox_key(g), 4 * l), None, n_beta, 2 * l), (u_sel, u_acc, n_beta, 2 * l, swaps)):
        before = (exchange_ops.exchange_cuda.launches, exchange_ops.exchange_cuda.launches_f64,
                  exchange_ops.exchange_cuda.launches_f64_tempered)
        ck, lk, _ = exchange_ops.exchange_cuda(work, cache, bonds, *args)
        assert (exchange_ops.exchange_cuda.launches, exchange_ops.exchange_cuda.launches_f64,
                exchange_ops.exchange_cuda.launches_f64_tempered) == (before[0], before[1] + 1, before[2] + (n_beta > 1))
        cp, lp, _ = exchange_ops.tempered_exchange_plain(work, cache, ln, bonds, *args)
        _f64_states_agree(ck, lk, cp, lp, 1e-2)
        up, dn = _sector_counts(ck.spins, l)
        assert bool((up == 5).all()) and bool((dn == 5).all())


@pytest.mark.gpu
@pytest.mark.parametrize("n", [16, 72])
@pytest.mark.parametrize("has_c", [False, True], ids=["rbm", "c"])
@pytest.mark.parametrize("case", F64_STRESS)
def test_float64_exchange_instance_on_stress_inputs(cuda, case, has_c, n):
    """The float64 exchange on utils/f64_stress.py's inputs (large |Re w|,
    H = 512 at G = 32, units near a zero of cosh, |Re w| = 25 at site 0,
    whose factors leave the double range four at a time) on two rings of
    N/2 sites: two sweeps of N proposals on the Philox stream against the
    plain float64 exchange, every walker row in its sectors."""
    w, b, a, c, spins = f64_stress_inputs(case, has_c, seed=7, n=n, k=300)
    work = Work(*(None if x is None else torch.as_tensor(x, device=cuda) for x in (w, b, a, c)))
    cache, ln = engine.full_forward(work, torch.as_tensor(spins, device=cuda))
    bonds = torch.as_tensor(kawasaki.two_ring_bonds(n // 2), device=cuda)
    draws = ExchangeDraws(philox_key(make_generator(9, cuda)), 2 * n)
    ck, lk, counts = exchange_ops.exchange_cuda(work, cache, bonds, draws, n_unit=n)
    cp, lp, _ = exchange_ops.tempered_exchange_plain(work, cache, ln, bonds, draws, None, 1, n)
    assert bool(torch.isfinite(ck.y).all()) and 0 < float(counts[0].sum()) < 2 * n * 300
    _f64_states_agree(ck, lk, cp, lp, 1e-2)
    for up, want in zip(_sector_counts(ck.spins, n // 2), _sector_counts(cache.spins, n // 2)):
        assert torch.equal(up, want)


@pytest.mark.gpu
@pytest.mark.parametrize("has_c", [False, True], ids=["rbm", "c"])
def test_float64_exchange_100_sweeps_in_one_launch(cuda, has_c):
    """A warm-up's launch of 100 sweeps at the L = 32 flagship's shape
    (N = 64 = B, H = 64: G = 16, U = 4), the state renewed from y after
    every sweep of n_unit = 64 proposals, against the plain float64 exchange
    on the same Philox draws, and the carried y against a fresh forward
    pass of the final spins."""
    l, h, k = 32, 64, 256
    work, _, _, g = _f64_machine(cuda, 2 * l, h, k, has_c, 73)
    ham = HubbardChain(n_sites=2 * l, n_up=5, n_down=5)
    cache, ln = engine.full_forward(work, ham.init_spins(g, k, torch.float64))
    bonds = torch.as_tensor(ham.bonds, device=cuda)
    draws = ExchangeDraws(philox_key(g), 100 * 2 * l)
    launches = exchange_ops.exchange_cuda.launches_f64
    ck, lk, counts = exchange_ops.exchange_cuda(work, cache, bonds, draws, n_unit=2 * l)
    assert exchange_ops.exchange_cuda.launches_f64 == launches + 1
    cp, lp, _ = exchange_ops.tempered_exchange_plain(work, cache, ln, bonds, draws, None, 1, 2 * l)
    _f64_states_agree(ck, lk, cp, lp, 1e-2)
    assert 0.0 < float(counts[0].sum()) < 100 * 2 * l * k
    fresh, _ = engine.full_forward(work, ck.spins)
    assert float((fresh.y - ck.y).abs().max()) <= 1e-10 * float(fresh.y.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("has_c", [False, True], ids=["rbm", "c"])
def test_float64_exchange_tempered_at_row0_with_n_beta_8(cuda, has_c):
    """The float64 exchange's tempered instances at n_beta = 8 on the
    Philox stream at row0 = K/2, a walker mesh's shard, two sweeps with
    their swap phases, against the plain tempered exchange on the same
    draws, with the per-row counts of accepted proposals and swaps."""
    l, h, k, n_beta = 32, 64, 512, 8
    work, _, _, g = _f64_machine(cuda, 2 * l, h, k, has_c, 83)
    ham = HubbardChain(n_sites=2 * l, n_up=5, n_down=5)
    cache, ln = engine.full_forward(work, ham.init_spins(g, k, torch.float64))
    bonds = torch.as_tensor(ham.bonds, device=cuda)
    draws = ExchangeDraws(philox_key(g), 2 * 2 * l, row0=k // 2)
    ck, lk, rows_k = exchange_ops.exchange_cuda(work, cache, bonds, draws, None, n_beta, 2 * l)
    cp, lp, rows_p = exchange_ops.tempered_exchange_plain(work, cache, ln, bonds, draws, None, n_beta, 2 * l)
    _f64_states_agree(ck, lk, cp, lp, 1e-2)
    same = ~((ck.spins != cp.spins).any(1) | near_branch_cut(ck.y) | near_branch_cut(cp.y))
    chains = same.reshape(-1, n_beta).all(1).repeat_interleave(n_beta)  # swaps couple the rows of a chain
    assert torch.equal(rows_k[:, chains], rows_p[:, chains]) and float(rows_k[1].sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["exchange", "energy"])
def test_float64_wrappers_refuse_weights_past_the_range_on_card(cuda, kernel):
    """The float64 exchange and energy wrappers on "Re w 25" inputs moved
    past the float64 kernels' range (engine.F64_MAX_RE_W): a ValueError,
    and no launch; the inputs at |Re w| = 25 run."""
    w, b, a, c, spins = f64_stress_inputs("Re w 25", False, seed=5, n=16, k=64)
    work = Work(*(None if x is None else torch.as_tensor(x, device=cuda) for x in (w, b, a, c)))
    cache, _ = engine.full_forward(work, torch.as_tensor(spins, device=cuda))
    bonds = torch.as_tensor(kawasaki.two_ring_bonds(8), device=cuda)
    draws = ExchangeDraws(philox_key(make_generator(3, cuda)), 16)

    def run(work_):
        if kernel == "exchange":
            return exchange_ops.exchange_cuda(work_, cache, bonds, draws)
        return energy.offdiag_sum_cuda(work_, cache)

    run(work)
    launches = (exchange_ops.exchange_cuda.launches_f64, energy.offdiag_sum_cuda.launches_f64)
    past = work._replace(w=work.w + (engine.F64_MAX_RE_W + 1.0 - 25.0) * (work.w.real == 25.0))
    with pytest.raises(ValueError, match="Re w"):
        run(past)
    torch.cuda.synchronize()
    assert (exchange_ops.exchange_cuda.launches_f64, energy.offdiag_sum_cuda.launches_f64) == launches


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["litfi", "litfi_tempered", "hubbard", "hubbard_tempered"])
def test_float64_machine_runs_on_card(cuda, kind):
    """A float64 machine through VMC on the card: each sampler call is one
    launch of the sweep's or the exchange's float64 instance (tempered too),
    each spin-chain step one launch of the energy kernel's float64 instance,
    no float32 kernel and no plain version; finite energies."""
    nb = 4 if kind.endswith("tempered") else 1
    if kind.startswith("litfi"):
        machine, ham = RBMTrSymm(n_inputs=16, alpha=2, dtype=torch.float64), LITFIChain(n_sites=16)
    else:
        machine, ham = RBM(n_inputs=16, n_hiddens=16, dtype=torch.float64), HubbardChain(n_sites=16, n_up=3, n_down=3)
    vmc = VMC(machine, ham, VMCConfig(n_walkers=256, n_beta=nb, seed=2), device=cuda)
    counts = lambda: (sweep_ops.sweep_cuda.launches, sweep_ops.sweep_cuda.launches_f64,  # noqa: E731
                      exchange_ops.exchange_cuda.launches, exchange_ops.exchange_cuda.launches_f64,
                      exchange_ops.exchange_cuda.launches_f64_tempered, energy.offdiag_sum_cuda.launches,
                      energy.offdiag_sum_cuda.launches_f64,
                      sweep_ops.sweep_plain.calls + exchange_ops.exchange_plain.calls + energy.offdiag_sum_plain.calls)
    before = counts()
    params, state = vmc.init()
    state = vmc.warm_up(params, state, 20)
    _, state, history, _ = vmc.run(params, state, 4)
    got = tuple(a - b for a, b in zip(counts(), before))
    if kind.startswith("litfi"):
        assert got == (0, 5, 0, 0, 0, 0, 4, 0)
    else:
        assert got == (0, 0, 0, 5, 5 if nb > 1 else 0, 0, 0, 0)
        up, dn = _sector_counts(state.cache.spins, 8)
        assert bool((up == 3).all()) and bool((dn == 3).all())
    assert state.cache.y.dtype == torch.complex128
    assert all(np.isfinite(h["energy"]) for h in history)


@pytest.mark.gpu
def test_train_driver_resumes_on_card(cuda, tmp_path):
    """The train driver on the card (its default device): a float64 run
    writes its text checkpoint, state and metrics, and -resume continues the
    step count and the lambda schedule through the float64 kernels."""
    from neural_network_quantum_state_tpu_torch.drivers import train

    common = ["-model=LICH", "-ansatz=rbmtrsymm", "-L=16", "-nf=2", "-alpha=2.5", "-theta=2", "-ns=256",
              "-dtype=float64", f"-path={tmp_path}", "-nrec=5"]
    f64_before = sweep_ops.sweep_cuda.launches_f64
    res = train.main(common + ["-niter=10", "-nwarm=20"])[0]
    assert sweep_ops.sweep_cuda.launches_f64 == f64_before + 1 + 10
    for suffix in ("", ".state.npz", ".metrics.jsonl"):
        assert (tmp_path / (res["prefix"].split("/")[-1] + suffix)).exists()
    res2 = train.main(common + ["-niter=3", f"-resume={res['prefix'].split('/')[-1]}"])[0]
    assert [h["step"] for h in res2["history"]] == [10, 11, 12]
    import json

    lam = {r["step"]: r["lam"] for r in map(json.loads, open(res["prefix"] + ".metrics.jsonl"))}
    assert abs(lam[10] - 100.0 * 0.9**11) < 1e-9
    assert all(np.isfinite(h["energy"]) for h in res2["history"])


def _launch_counts():
    """(sweep launches, exchange launches, tempered exchange launches,
    energy launches, plain calls of the sweep, exchange and energy)."""
    return (sweep_ops.sweep_cuda.launches, exchange_ops.exchange_cuda.launches,
            exchange_ops.exchange_cuda.launches_tempered, energy.offdiag_sum_cuda.launches,
            sweep_ops.sweep_plain.calls + exchange_ops.exchange_plain.calls + energy.offdiag_sum_plain.calls)


@pytest.mark.gpu
@pytest.mark.parametrize("n_beta", [1, 4])
def test_amplitude_sampler_makes_one_sweep_launch_per_iteration_on_card(cuda, n_beta):
    """AmplitudeSampler on the card: the warm-up and every run_estimator
    iteration are one sweep-kernel launch each (the ladder in the kernel
    for n_beta = 4), no plain version runs, and the estimator body sees the
    contiguous beta = 1 slice [::n_beta]."""
    from neural_network_quantum_state_tpu_torch.measurements import AmplitudeSampler

    tm = RBMTrSymm(n_inputs=16, alpha=2, dtype=torch.float32)
    params = {k: 3.0 * v for k, v in tm.init_params(make_generator(2, cuda)).items()}
    smp = AmplitudeSampler(tm, params, 1024, key=3, n_beta=n_beta)
    assert smp.state.cache.spins.device.type == "cuda"  # the card by default
    seen = []

    def accum(cache, lnpsi):
        seen.append((tuple(cache.spins.shape), cache.spins.is_contiguous(), lnpsi.is_contiguous()))
        return cache.spins.mean(), lnpsi.real.mean()

    before = _launch_counts()
    smp.warm_up(20)
    out = smp.run_estimator(accum, 7, n_sweeps=3, chunk=3)
    got = tuple(a - b for a, b in zip(_launch_counts(), before))
    assert got == (8, 0, 0, 0, 0)
    assert seen == [((1024 // n_beta, 16), True, True)] * 7
    assert out[0].shape == (7,) and np.isfinite(out[1]).all()
    torch.testing.assert_close(smp.spins, smp.state.cache.spins[::n_beta])
    torch.testing.assert_close(smp.log_psi(smp.spins), smp.lnpsi, rtol=0, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("n_beta", [1, 4])
def test_fermion_sampler_keeps_sectors_per_replica_on_card(cuda, n_beta):
    """FermionAmplitudeSampler on the card: one exchange launch per sampler
    call (of the tempered instance for n_beta = 4), no plain version, every
    replica in its (3, 2) sector, the density summing to 5 on the beta = 1
    slice."""
    from neural_network_quantum_state_tpu_torch.measurements.fermion import FermionAmplitudeSampler, density_profile

    tm = RBM(n_inputs=16, n_hiddens=24, dtype=torch.float32)
    params = {k: 3.0 * v for k, v in tm.init_params(make_generator(5, cuda)).items()}
    smp = FermionAmplitudeSampler(tm, params, 1024, 3, 2, key=7, n_beta=n_beta)
    before = _launch_counts()
    occ = density_profile(smp, 6, n_sweeps=2, n_warmup=30)
    got = tuple(a - b for a, b in zip(_launch_counts(), before))
    assert got == (0, 7, 7 if n_beta > 1 else 0, 0, 0)
    up, dn = _sector_counts(smp.state.cache.spins, 8)
    assert bool((up == 3).all()) and bool((dn == 2).all())
    assert occ.shape == (16,) and abs(occ.sum() - 5.0) < 1e-5
    assert smp.spins.shape == (1024 // n_beta, 16)


@pytest.mark.gpu
@pytest.mark.parametrize("n_beta", [1, 4])
def test_estimators_match_exact_enumeration_at_n12_on_card(cuda, n_beta):
    """The magnetization moments and <s_i s_j> of RBMTrSymm(12, alpha=4)
    (fixed scaled parameters) sampled on the card against exact
    enumeration of the 2^12 states on the card."""
    from neural_network_quantum_state_tpu_torch.measurements import (
        AmplitudeSampler, spin_z_correlation, spontaneous_magnetization,
    )

    n = 12
    tm = RBMTrSymm(n_inputs=n, alpha=4, dtype=torch.float32)
    params = {k: 4.0 * v for k, v in tm.init_params(make_generator(12, cuda)).items()}
    idx = torch.arange(2**n, device=cuda)
    spins = (1 - 2 * ((idx[:, None] >> torch.arange(n, device=cuda)) & 1)).to(torch.float32)
    ln = engine.log_psi(tm.make_work(params), spins).to(torch.complex128)
    p = torch.exp(2.0 * (ln.real - ln.real.max()))
    p = (p / p.sum()).cpu().numpy()
    s = spins.double().cpu().numpy()
    m_abs = np.abs(s.mean(1))
    m1, m2, _ = spontaneous_magnetization(AmplitudeSampler(tm, params, 4096, key=1, n_beta=n_beta), 40, 2, 200)
    assert abs(m1 - (p * m_abs).sum()) < 0.01 and abs(m2 - (p * m_abs**2).sum()) < 0.01, (m1, m2)
    zz = spin_z_correlation(AmplitudeSampler(tm, params, 4096, key=2, n_beta=n_beta), 40, 2, 200)
    np.testing.assert_allclose(zz, (s[:, :, None] * s[:, None, :] * p[:, None, None]).sum(0), atol=0.03)


@pytest.mark.gpu
def test_measure_driver_runs_on_card(cuda, tmp_path, capsys):
    """The measure driver on its default device: -what=energy on a spin
    chain through the sweep and energy kernels (one energy launch per
    iteration), -what=density through the tempered exchange instance."""
    from neural_network_quantum_state_tpu_torch.drivers import measure
    from neural_network_quantum_state_tpu_torch.utils.checkpoint import save_reference_text

    tm = RBMTrSymm(n_inputs=16, alpha=2, dtype=torch.float32)
    save_reference_text(tm, tm.init_params(make_generator(1, "cpu")), str(tmp_path / "spin"))
    th = RBM(n_inputs=16, n_hiddens=16, dtype=torch.float32)
    save_reference_text(th, th.init_params(make_generator(2, "cpu")), str(tmp_path / "hub"))
    before = _launch_counts()
    e, err = measure.main(["-what=energy", "-model=LICH", "-theta=1", "-alpha=2.5", "-ansatz=rbmtrsymm", "-L=16",
                           "-nf=2", "-ns=512", f"-prefix={tmp_path}/spin", "-niter=6", "-nwarm=20", "-fused=1"])
    assert tuple(a - b for a, b in zip(_launch_counts(), before)) == (1 + 6, 0, 0, 6, 0)
    assert np.isfinite(e.real) and np.isfinite(err)
    occ = measure.main(["-what=density", "-ansatz=rbm", "-L=16", "-nf=16", "-ns=512", "-npar=2,2", "-nbeta=4",
                        f"-prefix={tmp_path}/hub", "-niter=5", "-nwarm=20"])
    assert abs(occ.sum() - 4.0) < 1e-5 and (tmp_path / "hub.density.dat").exists()
    assert "# sum n = 4.0000" in capsys.readouterr().out
    # -init=neel: the Neel row, a tensor on the card, starts every glued chain
    s2, err = measure.main(["-what=renyi_inc", "-l=4", "-z2q=1", "-init=neel", "-ansatz=rbmtrsymm", "-L=16", "-nf=2",
                            "-ns=64", f"-prefix={tmp_path}/spin", "-niter=4", "-nwarm=2"])
    assert np.isfinite(s2) and np.isfinite(err)
    assert tuple(a - b for a, b in zip(_launch_counts(), before))[-1] == 0


def _row0_case(cuda, kind, dtype, has_c, seed):
    """Work, cache, ln psi and generator of a row0 case: the sweep on a
    chain of 16 sites or the exchange on the L = 16 Hubbard chain, K = 512."""
    k = 512
    if kind == "sweep":
        n = 16
        if dtype == torch.float64:
            return _f64_machine(cuda, n, 48, k, has_c, seed), None
        return (_scaled_ffnn if has_c else _scaled_rbm)(cuda, n, 48, k, seed), None
    l = 16
    if dtype == torch.float64:
        work, _, _, g = _f64_machine(cuda, 2 * l, 48, 8, has_c, seed)
    else:
        work, _, _, g = (_scaled_ffnn if has_c else _scaled_rbm)(cuda, 2 * l, 48, 8, seed)
    ham = HubbardChain(n_sites=2 * l, n_up=3, n_down=4)
    cache, ln = engine.full_forward(work, ham.init_spins(g, k, dtype))
    return (work, cache, ln, g), ham


@pytest.mark.gpu
@pytest.mark.parametrize("has_c", [False, True], ids=["rbm", "c"])
@pytest.mark.parametrize("n_beta", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("kind", ["sweep", "exchange"])
def test_every_sampler_instance_at_row0_matches_plain(cuda, kind, dtype, n_beta, has_c):
    """Every instance of the sweep and exchange kernels (float32, float64,
    n_beta = 1 and tempered, with and without c) on its Philox stream at
    row0 = K/2 (a walker mesh's shard) against its plain version on the same
    draws: the same decisions but for near-ties and near-cut walkers, y and
    ln psi where they agree; the plain draws are the columns K/2 .. 3K/2 of
    a call over 2K walkers."""
    (work, cache, ln, g), ham = _row0_case(cuda, kind, dtype, has_c, 40 + n_beta)
    k = cache.spins.shape[0]
    key = philox_key(g)
    if kind == "sweep":
        sched = torch.as_tensor(chain_checkerboard(cache.spins.shape[1]), device=cuda)
        draws = PhiloxDraws(key, 2 * sched.shape[0], row0=k // 2)
        assert torch.equal(draws.flips(k), PhiloxDraws(key, 2 * sched.shape[0]).flips(2 * k)[:, k // 2:3 * k // 2])
        ck, lk, _ = sweep_ops.sweep_cuda(work, cache, sched, draws, n_beta)
        cp, lp, _ = sweep_ops.sweep_plain(work, cache, ln, sched, draws, n_beta)
    else:
        bonds = torch.as_tensor(ham.bonds, device=cuda)
        n_unit = ham.n_unit_steps
        draws = ExchangeDraws(key, 2 * n_unit, row0=k // 2)
        ck, lk, _ = exchange_ops.exchange_cuda(work, cache, bonds, draws, None, n_beta, n_unit)
        cp, lp, _ = exchange_ops.tempered_exchange_plain(work, cache, ln, bonds, draws, None, n_beta, n_unit)
        up, dn = _sector_counts(ck.spins, ham.n_sites // 2)
        assert bool((up == 3).all()) and bool((dn == 4).all())
    if dtype == torch.float64:
        _f64_states_agree(ck, lk, cp, lp, 1e-2)
    else:
        same = _agreeing(ck, cp, 2e-2)
        torch.testing.assert_close(ck.y[same], cp.y[same], rtol=0, atol=2e-5)
        torch.testing.assert_close(lk[same], lp[same], rtol=0, atol=2e-4)
    # the rows of another offset draw other numbers: the decisions move
    other = sweep_ops.sweep_cuda(work, cache, sched, draws._replace(row0=0), n_beta)[0] if kind == "sweep" else \
        exchange_ops.exchange_cuda(work, cache, bonds, draws._replace(row0=0), None, n_beta, n_unit)[0]
    assert not torch.equal(other.spins, ck.spins)


@pytest.mark.gpu
@pytest.mark.parametrize("n_beta", [1, 4])
@pytest.mark.parametrize("kind", ["sweep", "exchange"])
def test_four_shard_call_equals_the_unsharded_launch(cuda, kind, n_beta):
    """A sampler call on a 4-shard mesh of the card (four launches on one
    key, each at its shard's first row) makes the unsharded launch's
    decisions: the spins to the bit, y and ln psi equal, the counters
    equal, and four launches against one."""
    from neural_network_quantum_state_tpu_torch.parallel import gather, make_mesh, shard_walker_tree

    (work, cache, _, _), ham = _row0_case(cuda, kind, torch.float32, False, 60 + n_beta)
    k = cache.spins.shape[0]
    state = init_state(work, cache.spins, make_generator(8, cuda))
    if kind == "sweep":
        sched = torch.as_tensor(chain_checkerboard(cache.spins.shape[1]), device=cuda)
        run = lambda st: tempering.tempering_sweeps(work, st, sched, 3, n_beta) if n_beta > 1 else \
            metropolis.sweeps(work, st, sched, 3)  # noqa: E731
        count = lambda: sweep_ops.sweep_cuda.launches  # noqa: E731
    else:
        bonds = torch.as_tensor(ham.bonds, device=cuda)
        run = lambda st: kawasaki.tempered_exchange_sweeps(work, st, bonds, 3, ham.n_unit_steps, n_beta)  # noqa: E731
        count = lambda: exchange_ops.exchange_cuda.launches  # noqa: E731
    before = count()
    one = run(state._replace(generator=make_generator(9, cuda)))
    assert count() == before + 1
    mesh = make_mesh(4, device="cuda")
    sharded = shard_walker_tree(state._replace(generator=make_generator(9, cuda)), mesh, k)
    got = run(sharded)
    assert count() == before + 1 + 4
    assert torch.equal(gather(got.cache.spins), one.cache.spins)
    torch.testing.assert_close(gather(got.cache.y), one.cache.y, rtol=0, atol=0)
    torch.testing.assert_close(gather(got.lnpsi), one.lnpsi, rtol=0, atol=1e-6)
    assert float(got.n_accepted) == float(one.n_accepted)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["sweep", "exchange"])
def test_every_mesh_launch_runs_on_its_shards_card(cuda, kind, monkeypatch):
    """A VMC on a mesh of two shards a visible card, the cards in reverse
    order (shard 0 on the last card), run in a worker thread as a -gridmesh
    grid point is (a fresh thread's current card is cuda:0): every C launch
    of the sweep (or exchange) and energy kernels is made with its shard's
    card current, in mesh order, and the energies equal one device's."""
    import concurrent.futures

    from neural_network_quantum_state_tpu_torch.parallel import make_mesh

    cards = [torch.device("cuda", i) for i in reversed(range(torch.cuda.device_count()))]
    mesh = make_mesh([c for c in cards for _ in range(2)])
    current = []

    def spy(get):
        def wrapped(*a):
            fn = get(*a)

            def call(*args):
                current.append(torch.cuda.current_device())
                return fn(*args)

            return call

        return wrapped

    monkeypatch.setattr(sweep_ops, "_kernel", spy(sweep_ops._kernel))
    monkeypatch.setattr(exchange_ops, "_launcher", spy(exchange_ops._launcher))
    monkeypatch.setattr(energy, "_kernel", spy(energy._kernel))
    if kind == "sweep":
        machine, ham = RBMTrSymm(n_inputs=16, alpha=2, dtype=torch.float32), LITFIChain(16, h=-0.5, j=0.866, alpha=2.5)
    else:
        machine, ham = RBM(n_inputs=32, n_hiddens=32, dtype=torch.float32), HubbardChain(n_sites=32, n_up=3, n_down=4)
    cfg = VMCConfig(n_walkers=512, learning_rate=1e-2, seed=5)

    def train(m, device):
        vmc = VMC(machine, ham, cfg, mesh=m, device=device)
        params, state = vmc.init()
        state = vmc.warm_up(params, state, 10)
        _, _, history, _ = vmc.run(params, state, 3)
        return [h["energy"] for h in history]

    one = train(None, cards[0])
    current.clear()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        sharded = pool.submit(train, mesh, None).result()
    order = [d.index for d in mesh.devices]
    assert current and len(current) % mesh.size == 0
    assert current == order * (len(current) // mesh.size)
    np.testing.assert_allclose(sharded[0], one[0], rtol=1e-6, atol=0)  # the same walkers, sums in another order
    np.testing.assert_allclose(sharded, one, rtol=1e-4, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("n_beta", [4, 8])
def test_tempered_exchange_five_sweeps_pass_the_gate_by_chain(cuda, n_beta):
    """C9: chip_smoke.py phase 3's float32 tempered exchange check (the
    Hubbard flagship's shapes, 5 sweeps in one launch on the Philox stream)
    on 12 fresh draws of its inputs, gated by chain (utils/ties.py): the
    near-tie chains at most 1% of the chains, the other parting chains' rows
    at most 1e-3 of the rows, y and ln psi on the agreeing rows as in phase 3."""
    from neural_network_quantum_state_tpu_torch.utils import ties

    l, h, k, sweeps = 32, 64, 4096, 5
    trap = tuple(float(0.05 * (i - (l - 1) / 2.0) ** 2) for i in range(l)) * 2
    ham = HubbardChain(n_sites=2 * l, u=4.0, t=1.0, n_up=5, n_down=5, pbc=True, v=trap)
    machine = RBM(n_inputs=2 * l, n_hiddens=h)
    bonds = torch.as_tensor(ham.bonds, device=cuda)
    n_unit = ham.n_unit_steps
    for seed in range(12):
        g = make_generator(seed, cuda)
        work = machine.make_work({name: 10.0 * v for name, v in machine.init_params(g).items()})
        cache, ln = engine.full_forward(work, ham.init_spins(g, k))
        draws = ExchangeDraws(philox_key(g), sweeps * n_unit)
        ck, lk, _ = exchange_ops.exchange_cuda(work, cache, bonds, draws, n_beta=n_beta, n_unit=n_unit)
        cp, lp, _ = exchange_ops.tempered_exchange_plain(work, cache, ln, bonds, draws, n_beta=n_beta, n_unit=n_unit)
        differ = (ck.spins != cp.spins).any(1)
        chains = ties.find_ties(work, cache, bonds, draws, n_beta, n_unit)[0] if bool(differ.any()) else []
        gate = ties.tie_gate(chains, differ, n_beta, 1e-3)
        assert gate["passes"], (seed, chains)
        same = ~(differ | gate["near_rows"])
        torch.testing.assert_close(ck.y[same], cp.y[same], rtol=0, atol=1e-5)
        torch.testing.assert_close(lk[same], lp[same], rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_tfi_chain_on_card_matches_the_ports_exact_diagonalization(cuda):
    """The user-level recipe on the card: RBM(10, 20) on the TFI chain,
    K = 512, against the port's dense ED (utils/exact.py), rel. err < 1e-4."""
    from neural_network_quantum_state_tpu_torch.utils.exact import ground_energy, tfi_chain_dense

    n = 10
    vmc = VMC(RBM(n_inputs=n, n_hiddens=2 * n, dtype=torch.float32), TFIChain(n_sites=n, h=-1.0, j=-1.0),
              VMCConfig(n_walkers=512, learning_rate=1e-2, seed=7), device=cuda)
    params, state = vmc.init()
    state = vmc.warm_up(params, state, 300)
    launches = sweep_ops.sweep_cuda.launches
    params, state, history, _ = vmc.run(params, state, 800)
    assert sweep_ops.sweep_cuda.launches == launches + 800
    e = float(np.mean([h["energy"] for h in history[-20:]]))
    e_exact = ground_energy(tfi_chain_dense(n, h=-1.0, j=-1.0))
    assert abs(e - e_exact) / abs(e_exact) < 1e-4, (e, e_exact)


@pytest.mark.gpu
def test_litfi_chain_on_card_matches_the_ports_lanczos(cuda):
    """The paper's model on the card: RBMTrSymm(12, alpha 2) on the LITFI
    chain (theta = 2, alpha_J = 2), against the port's Lanczos ED at the JAX
    e2e oracle's bar for it (tests/test_e2e.py, 1e-2)."""
    from neural_network_quantum_state_tpu_torch.utils.exact import litfi_ground_state_lanczos

    n, theta = 12, 2.0
    ham = LITFIChain(n_sites=n, h=float(-np.cos(theta)), j=float(np.sin(theta)), alpha=2.0, pbc=True)
    vmc = VMC(RBMTrSymm(n_inputs=n, alpha=2, dtype=torch.float32), ham,
              VMCConfig(n_walkers=256, learning_rate=2e-2, solver="cg", seed=3), device=cuda)
    params, state = vmc.init()
    state = vmc.warm_up(params, state, 200)
    params, state, history, _ = vmc.run(params, state, 1200)
    e = float(np.mean([h["energy"] for h in history[-50:]]))
    e_exact, _ = litfi_ground_state_lanczos(n, theta, 2.0)
    assert abs(e - e_exact) / abs(e_exact) < 1e-2, (e, e_exact)


@pytest.mark.gpu
def test_precision_anchor_trains_on_card_through_the_kernels(cuda, tmp_path):
    """examples/precision_anchor.py's stages on the card at a small size:
    every sampler call one sweep launch, every step one energy launch, no
    plain version, the tail energy within 1e-2 of the port's ED."""
    from neural_network_quantum_state_tpu_torch.examples import precision_anchor

    e0 = precision_anchor.run_ed(8, str(tmp_path))
    sweeps, energies = sweep_ops.sweep_cuda.launches, energy.offdiag_sum_cuda.launches
    plain = sweep_ops.sweep_plain.calls + energy.offdiag_sum_plain.calls
    rec = precision_anchor.run_train(8, str(tmp_path), device="cuda", n_walkers=512, warm_sweeps=200,
                                     stages=((800, 2e-2), (400, 5e-3)), tail=100)
    assert sweep_ops.sweep_cuda.launches - sweeps == 1 + 1200
    assert energy.offdiag_sum_cuda.launches - energies == 1200
    assert sweep_ops.sweep_plain.calls + energy.offdiag_sum_plain.calls == plain
    assert abs(rec["e_vmc"] - e0) / abs(e0) < 1e-2
    assert (tmp_path / "precision_anchor_vmc_N8.json").exists()


@pytest.mark.gpu
@pytest.mark.parametrize("run", ["one", "mesh4"])
def test_jax_orbax_fixtures_resume_on_card(cuda, run, tmp_path):
    """The committed JAX -ckpt=orbax runs (``tests/fixtures/jax_orbax``, one
    device and -mesh=4) read with no JAX onto the card, to their text
    checkpoint's 8 digits, and resumed there by the train driver: the steps
    continue, one sweep and one energy launch per step, no plain call."""
    import shutil
    from pathlib import Path

    from neural_network_quantum_state_tpu_torch.drivers import train
    from neural_network_quantum_state_tpu_torch.utils.checkpoint import load_orbax, load_reference_text

    prefix = "RBMTrSymmLICH-L16NF2A2T0V1"
    src = Path(__file__).resolve().parent / "fixtures" / "jax_orbax" / run
    m = RBMTrSymm(n_inputs=16, alpha=2, dtype=torch.float32)
    params, step, gen, spins, _ = load_orbax(str(src / (prefix + ".orbax")), m, device=cuda)
    assert step == 5 and gen.device.type == "cuda" and spins.is_cuda and spins.shape == (512, 16)
    assert set(spins.unique().tolist()) == {-1.0, 1.0}
    text = load_reference_text(m, str(src / prefix), device="cpu")
    for name, p in params.items():
        assert p.is_cuda
        np.testing.assert_allclose(p.cpu().numpy(), text[name].numpy(), rtol=1e-7, atol=0)
    shutil.copytree(src / (prefix + ".orbax"), tmp_path / (prefix + ".orbax"))
    sweeps, energies = sweep_ops.sweep_cuda.launches, energy.offdiag_sum_cuda.launches
    plain = sweep_ops.sweep_plain.calls + energy.offdiag_sum_plain.calls
    res = train.main(["-model=LICH", "-ansatz=rbmtrsymm", "-L=16", "-nf=2", "-ns=512", "-niter=3", "-nrec=0",
                      "-ckpt=orbax", f"-path={tmp_path}", f"-resume={prefix}"])
    assert [h["step"] for h in res[0]["history"]] == [5, 6, 7]
    assert sweep_ops.sweep_cuda.launches - sweeps == 3 and energy.offdiag_sum_cuda.launches - energies == 3
    assert sweep_ops.sweep_plain.calls + energy.offdiag_sum_plain.calls == plain
    assert load_orbax(str(tmp_path / (prefix + ".orbax")), m, device=cuda)[1] == 8
