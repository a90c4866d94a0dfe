"""The port's block-flip moves (sampler/metropolis.py::block_flip_moves) on
the cases of tests/test_blockflip.py: |psi|^2 preserved, the cache
consistent, beta = 0 always accepting, the exchange sampler refusing them;
and acceptance_ratio."""

import numpy as np
import pytest
import torch

from neural_network_quantum_state_tpu.utils.exact import spins_to_index
from neural_network_quantum_state_tpu_torch import VMC, VMCConfig
from neural_network_quantum_state_tpu_torch.hamiltonians import HubbardChain, TFIChain
from neural_network_quantum_state_tpu_torch.models import RBM
from neural_network_quantum_state_tpu_torch.ops import engine
from neural_network_quantum_state_tpu_torch.ops.rng import make_generator, random_spins
from neural_network_quantum_state_tpu_torch.sampler import (
    acceptance_ratio,
    block_flip_moves,
    chain_checkerboard,
    init_state,
    sweeps,
)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _setup(n=4, k=4096, seed=3):
    machine = RBM(n_inputs=n, n_hiddens=8, dtype=torch.float64)
    g = make_generator(seed, "cpu")
    params = {name: 4.0 * v for name, v in machine.init_params(g).items()}  # a |psi|^2 far from uniform
    work = machine.make_work(params)
    return work, init_state(work, random_spins(g, k, n, torch.float64), g)


def test_block_flips_preserve_psi_squared():
    """Sweeps + block moves keep |psi|^2 on the 2^N histogram (the move is
    symmetric): every configuration within 5 sigma + 2e-3 of exact."""
    n, k = 4, 4096
    work, state = _setup(n, k)
    idx = np.arange(2**n)
    all_spins = torch.as_tensor(1.0 - 2.0 * ((idx[:, None] >> np.arange(n)[None, :]) & 1), dtype=torch.float64)
    p_exact = np.exp(2.0 * engine.log_psi(work, all_spins).real.numpy())
    p_exact /= p_exact.sum()
    schedule = torch.as_tensor(chain_checkerboard(n))
    state = block_flip_moves(work, sweeps(work, state, schedule, 20), n_moves=50)
    counts = np.zeros(2**n)
    for _ in range(4):
        state = block_flip_moves(work, sweeps(work, state, schedule, 5), n_moves=10)
        counts += np.bincount(spins_to_index(state.cache.spins.numpy()), minlength=2**n)
    p_emp = counts / (4 * k)
    assert np.all(np.abs(p_emp - p_exact) < 5.0 * np.sqrt(p_exact / (4 * k)) + 2e-3), (p_emp, p_exact)
    # block moves alone too: with the sweeps frozen, they still sample |psi|^2
    work, state = _setup(n, k)
    state = block_flip_moves(work, state, n_moves=60)
    p_blk = np.bincount(spins_to_index(state.cache.spins.numpy()), minlength=2**n) / k
    assert np.all(np.abs(p_blk - p_exact) < 5.0 * np.sqrt(p_exact / k) + 4e-3), (p_blk, p_exact)


def test_block_flips_keep_the_cache_consistent():
    """After block moves the cache equals a fresh forward of the spins, and
    the single-flip counters are untouched."""
    work, state = _setup(n=6, k=128)
    moved = block_flip_moves(work, state, n_moves=7)
    assert not torch.equal(moved.cache.spins, state.cache.spins)
    fresh, lnpsi = engine.full_forward(work, moved.cache.spins)
    torch.testing.assert_close(moved.lnpsi, lnpsi, rtol=0, atol=1e-12)
    torch.testing.assert_close(moved.cache.y, fresh.y, rtol=0, atol=1e-12)
    torch.testing.assert_close(moved.cache.sa, fresh.sa, rtol=0, atol=1e-12)
    assert float(moved.n_accepted) == float(moved.n_proposed) == 0.0


def test_block_flips_at_beta_zero_always_accept():
    """beta = 0 replicas sample the uniform distribution: every walker flips
    a non-empty block in one move."""
    work, state = _setup(n=8, k=64)
    moved = block_flip_moves(work, state, n_moves=1, beta=torch.zeros(64, dtype=torch.float64))
    assert ((moved.cache.spins != state.cache.spins).sum(1) > 0).all()


def test_vmc_wraps_the_sampler_with_block_moves():
    """block_moves_per_sweep = 2 appends 2 moves per sweep to the sampler
    (tempered: with the replicas' beta); an exchange Hamiltonian refuses."""
    n, k = 6, 64
    calls = []
    import neural_network_quantum_state_tpu_torch.sampler.metropolis as metropolis

    real = metropolis.block_flip_moves

    def spy(work, state, n_moves=1, max_block=None, beta=None):
        calls.append((n_moves, None if beta is None else beta[:4].tolist()))
        return real(work, state, n_moves, max_block, beta)

    metropolis.block_flip_moves = spy
    try:
        for nb in (1, 4):
            vmc = VMC(RBM(n_inputs=n, n_hiddens=4, dtype=torch.float64), TFIChain(n_sites=n),
                      VMCConfig(n_walkers=k, n_beta=nb, block_moves_per_sweep=2, seed=1), device="cpu")
            params, state = vmc.init()
            state = vmc.warm_up(params, state, 3)
            vmc.run(params, state, 1)
    finally:
        metropolis.block_flip_moves = real
    assert calls == [(6, None), (2, None), (6, [1.0, 0.75, 0.5, 0.25]), (2, [1.0, 0.75, 0.5, 0.25])]
    with pytest.raises(ValueError, match="particle conservation"):
        VMC(RBM(n_inputs=8, n_hiddens=8, dtype=torch.float64), HubbardChain(n_sites=8, n_up=1, n_down=1),
            VMCConfig(n_walkers=64, block_moves_per_sweep=1), device="cpu")


def test_acceptance_ratio_reads_and_resets():
    work, state = _setup(n=6, k=64)
    state = sweeps(work, state, torch.as_tensor(chain_checkerboard(6)), 3)
    ratio, fresh = acceptance_ratio(state)
    assert float(ratio) == pytest.approx(float(state.n_accepted) / (3 * 6 * 64)) and 0.0 < float(ratio) < 1.0
    assert float(fresh.n_accepted) == float(fresh.n_proposed) == 0.0
    assert float(acceptance_ratio(fresh)[0]) == 0.0
