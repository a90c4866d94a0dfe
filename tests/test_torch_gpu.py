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
from neural_network_quantum_state_tpu_torch.hamiltonians import LITFIChain
from neural_network_quantum_state_tpu_torch.models import RBMTrSymm
from neural_network_quantum_state_tpu_torch.ops import energy, engine
from neural_network_quantum_state_tpu_torch.ops import sweep as sweep_ops
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
