"""The port's VMC end to end: ground-state energies vs exact diagonalization
(the JAX package's e2e oracles), and the options it refuses."""

import dataclasses

import numpy as np
import pytest
import torch

from neural_network_quantum_state_tpu.utils.exact import ground_energy, litfi_chain_dense
from neural_network_quantum_state_tpu_torch import VMC, VMCConfig
from neural_network_quantum_state_tpu_torch.hamiltonians import LITFIChain, TFIChain
from neural_network_quantum_state_tpu_torch.models import RBM, RBMTrSymm
from neural_network_quantum_state_tpu_torch.optim import SRStats
from neural_network_quantum_state_tpu_torch.ops import energy, engine
from neural_network_quantum_state_tpu_torch.ops import sweep as sweep_ops


def _final_energy(history, tail=15):
    return float(np.mean([h["energy"] for h in history[-tail:]]))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["float64", "float32"])
def test_litfi_chain_converges_to_exact(dtype):
    """Long-range AFM chain (the paper's model) with the TrSymm RBM, in
    float64 and in the float32 that the card's kernels run."""
    n = 8
    theta = 2.0  # J = sin(theta) > 0 AFM, h = -cos(theta)
    j, h = float(np.sin(theta)), float(-np.cos(theta))
    machine = RBMTrSymm(n_inputs=n, alpha=2, dtype=dtype)
    ham = LITFIChain(n_sites=n, h=h, j=j, alpha=2.0, pbc=True)
    cfg = VMCConfig(n_walkers=256, learning_rate=2e-2, solver="cg", seed=3, use_fused_sweeps=dtype == torch.float32)
    vmc = VMC(machine, ham, cfg, device="cpu")
    params, state = vmc.init()
    state = vmc.warm_up(params, state, 200)
    params, state, history, _ = vmc.run(params, state, 1200)
    e_exact = ground_energy(litfi_chain_dense(n, h=h, j=j, alpha=2.0, pbc=True))
    rel = abs(_final_energy(history, tail=50) - e_exact) / abs(e_exact)
    assert rel < 1e-2, (rel, _final_energy(history, tail=50), e_exact)
    acceptance = [r["acceptance"] for r in history]
    assert all(0.0 <= a <= 1.0 for a in acceptance) and 0.0 < np.mean(acceptance) < 1.0


@pytest.mark.parametrize(
    "change",
    [
        {"solver": "cholesky"},
        {"n_beta": 4},
        {"energy_dtype": torch.float64},
        {"precond_ema": 0.9},
        {"block_moves_per_sweep": 1},
        {"mesh": object()},
    ],
    ids=["solver", "n_beta", "energy_dtype", "precond_ema", "block_moves", "mesh"],
)
def test_unported_options_raise(change):
    machine = RBM(n_inputs=4, n_hiddens=4, dtype=torch.float64)
    ham = TFIChain(n_sites=4)
    mesh = change.pop("mesh", None)
    with pytest.raises(NotImplementedError):
        VMC(machine, ham, dataclasses.replace(VMCConfig(), **change), mesh=mesh, device="cpu")


def test_config_checks_and_large_v_default():
    ham = TFIChain(n_sites=16)
    with pytest.raises(ValueError, match="float32"):
        VMC(RBM(n_inputs=16, n_hiddens=4, dtype=torch.float64), ham, VMCConfig(use_fused_sweeps=True), device="cpu")
    with pytest.raises(ValueError, match="dense solver"):
        VMC(RBM(n_inputs=16, n_hiddens=4), ham, VMCConfig(n_accumulations=2), device="cpu")
    with pytest.raises(NotImplementedError, match="float32"):
        VMC(RBM(n_inputs=16, n_hiddens=4, dtype=torch.float64), ham, VMCConfig(), device="cuda")
    big = VMC(RBM(n_inputs=16, n_hiddens=32), ham, VMCConfig(), device="cpu")  # V = 560
    assert big.config.solve_dtype == torch.float64
    small = VMC(RBM(n_inputs=16, n_hiddens=4), ham, VMCConfig(), device="cpu")
    assert small.config.solve_dtype is None


def test_collapse_reseeds_or_refuses_escalation():
    """rsd pinned at zero (walker collapse) reseeds half of the walkers when
    no tempering ladder is asked for; the escalation to tempering, not
    ported, raises instead of being skipped."""
    n, k = 8, 64
    machine = RBMTrSymm(n_inputs=n, alpha=1, dtype=torch.float64)
    ham = LITFIChain(n_sites=n, h=-0.5, j=1.0, alpha=2.0)  # Neel start
    cfg = VMCConfig(n_walkers=k, seed=1, collapse_patience=2, collapse_requil_sweeps=0)

    def collapsed_step(params, state, step_idx):
        return params, state, SRStats(energy=torch.tensor(-1.0 + 0j), rsd=torch.tensor(0.0), cg_iters=0, lam=1.0)

    vmc = VMC(machine, ham, dataclasses.replace(cfg, collapse_escalate_nbeta=1), device="cpu")
    vmc.step = collapsed_step
    params, state = vmc.init()
    neel = state.cache.spins.clone()
    _, state, history, _ = vmc.run(params, state, 4)
    assert vmc.n_remediations == 1 and len(history) == 4
    spins = state.cache.spins
    assert torch.equal(spins[1::2], neel[1::2]) and not torch.equal(spins[::2], neel[::2])
    fresh, _ = engine.full_forward(machine.make_work(params), spins)
    torch.testing.assert_close(state.cache.y, fresh.y)

    vmc = VMC(machine, ham, cfg, device="cpu")
    vmc.step = collapsed_step
    params, state = vmc.init()
    with pytest.raises(NotImplementedError, match="tempering"):
        vmc.run(params, state, 4)
