"""The port's VMC on the nearest-neighbour TFI chain vs exact
diagonalization (the JAX package's tests/test_e2e.py oracle; kept in a file
of its own so that each e2e file stays short in a parallel test run)."""

import numpy as np
import pytest
import torch

from neural_network_quantum_state_tpu.utils.exact import ground_energy, tfi_chain_dense
from neural_network_quantum_state_tpu_torch import VMC, VMCConfig
from neural_network_quantum_state_tpu_torch.hamiltonians import TFIChain
from neural_network_quantum_state_tpu_torch.models import RBM


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_tfi_chain_converges_to_exact():
    n = 8
    machine = RBM(n_inputs=n, n_hiddens=16, dtype=torch.float64)
    ham = TFIChain(n_sites=n, h=-1.0, j=-1.0)
    vmc = VMC(machine, ham, VMCConfig(n_walkers=256, learning_rate=1e-2, solver="cg", seed=11), device="cpu")
    params, state = vmc.init()
    state = vmc.warm_up(params, state, 200)
    params, state, history, _ = vmc.run(params, state, 400)
    e_exact = ground_energy(tfi_chain_dense(n, h=-1.0, j=-1.0))
    e_final = float(np.mean([h["energy"] for h in history[-15:]]))
    rel = abs(e_final - e_exact) / abs(e_exact)
    assert rel < 3e-3, (rel, e_final, e_exact)
